// Kernel C1: tape compaction straight from kernel A's shorten codes, with
// opcode-run headers.
//
// Replaces: mpr_tpu/ops/kernels.py::compact_runs (Pallas body
// `_compact_kernel`), the first public version of kernel C: no prepass,
// the shared tape and each tile's packed 4-bit codes in, a dense per-tile
// tape out whose words keep the OPCODE in their low byte (kernel C's hold
// the branch id).
//
// Bound on the H100: bytes.  A group reads its tile's code words (tcap / 2
// bytes) and, for each kept clause, a tape word and an immediate (8 bytes,
// shared by all groups, so they come from L2), and writes 8 bytes per kept
// clause plus the run headers.
//
// Design.  The TPU kernel walks the clauses serially, carrying the output
// position k.  What it computes is parallel: a clause is kept iff its
// nibble is non-zero and fewer than `cap` non-zero nibbles come before it,
// and its place is that count.  One block per group g < cmeta[0]: each
// thread takes a contiguous piece of the tile's code words, counts its
// non-zero nibbles, a block-wide exclusive sum gives its first place, and
// a second walk rewrites and stores the kept clauses:
//   COPY_LHS on a two-operand op     -> rhs := lhs      (min(a, a) == a)
//   COPY_LHS on MIN/MAX_LHS_IMM      -> imm := +inf / -inf
//   COPY_RHS                         -> lhs := rhs
//   COPY_IMM                         -> opcode COPY_IMM (the one run breaker)
// The branch id remap[new_op] of every kept clause goes to shared memory,
// and compact_core.cuh's emit_runs numbers the runs as for kernel C.
// Edges kept from the TPU kernel: len = min(count, cap) and overflow is
// `len >= cap`, so a tape of exactly cap clauses is flagged; the codes are
// not masked by the tape's length (cmeta[1] words are walked); slots past
// len keep what the allocation held, run headers past n_runs are zero.
// gmeta[g] = [len, n_runs, overflow, 0..].  Rows g >= cmeta[0] are left as
// allocated.

#include "clause.cuh"
#include "compact_core.cuh"

namespace {

using namespace mpr;

__device__ __forceinline__ int nonzero_nibbles(uint32_t cw) {
  const uint32_t any = (cw | (cw >> 1) | (cw >> 2) | (cw >> 3)) & 0x11111111u;
  return __popc(any);
}

__global__ void compact_runs_kernel(
    const int* __restrict__ cmeta,       // [n_groups, n_words, cap, ..]
    const uint32_t* __restrict__ words,  // (tcap,) shared tape
    const int* __restrict__ imm_bits,    // (tcap,) f32 bits
    const int* __restrict__ order,       // (gcap,)
    const int* __restrict__ remap,       // (32,) op -> branch id
    const uint32_t* __restrict__ codes,  // (n_tiles, tw_words)
    int* __restrict__ tw, int* __restrict__ ti, int* __restrict__ runs,
    int* __restrict__ gmeta, int n_tiles, int tw_words, int tcap, int cap,
    int rcap) {
  extern __shared__ int smem[];
  __shared__ int warp_sums[32];
  __shared__ int sremap[32];
  int* sstart = smem;                                        // rcap + 1
  unsigned char* sbid = reinterpret_cast<unsigned char*>(smem + rcap + 1);

  const int g = blockIdx.x;
  if (g >= cmeta[0]) return;
  const int tile = order[g];
  if (tile < 0 || tile >= n_tiles) return;   // a bad order entry: no access
  const int n_words = max(0, min(min(cmeta[1], tw_words), tcap / 8));
  const int capm = max(0, min(cmeta[2], cap));
  if (threadIdx.x < 32) sremap[threadIdx.x] = remap[threadIdx.x];

  const uint32_t* cw = codes + (size_t)tile * tw_words;
  const int per = (n_words + blockDim.x - 1) / blockDim.x;
  const int w0 = min((int)threadIdx.x * per, n_words);
  const int w1 = min(w0 + per, n_words);
  int mine = 0;
  for (int w = w0; w < w1; ++w) mine += nonzero_nibbles(cw[w]);
  int total;
  int k = block_exclusive_sum(mine, warp_sums, &total);  // syncs: sremap set

  int* tw_g = tw + (size_t)g * cap;
  int* ti_g = ti + (size_t)g * cap;
  for (int w = w0; w < w1 && k < capm; ++w) {
    const uint32_t c = cw[w];
    if (c == 0) continue;
    for (int j = 0; j < 8 && k < capm; ++j) {
      const int nib = (c >> (4 * j)) & 15;
      if (nib == 0) continue;
      const int t = w * 8 + j;
      const uint32_t word = words[t];
      const int op = w_op(word), lhs = w_lhs(word), rhs = w_rhs(word);
      const bool is_min_imm = op == OP_MIN_IMM, is_max_imm = op == OP_MAX_IMM;
      const bool imm_form = is_min_imm || is_max_imm;
      const bool take_rhs = nib == CODE_COPY_RHS;
      const int new_lhs = take_rhs ? rhs : lhs;
      const int new_rhs = (nib == CODE_COPY_LHS && !imm_form) ? lhs : rhs;
      const int new_op = nib == CODE_COPY_IMM ? (int)OP_COPY_IMM : op;
      int imm = imm_bits[t];
      if (nib == CODE_COPY_LHS && imm_form)
        imm = is_min_imm ? 0x7f800000 : (int)0xff800000u;
      tw_g[k] = (int)((uint32_t)new_op | (word & 0xFF00u)
                      | ((uint32_t)new_lhs << 16) | ((uint32_t)new_rhs << 24));
      ti_g[k] = imm;
      sbid[k] = (unsigned char)sremap[new_op & 31];
      ++k;
    }
  }
  __syncthreads();

  const int n = min(total, capm);
  const int n_runs = emit_runs(sbid, n, max(n_words * 8, 1), rcap, sstart,
                               warp_sums, runs + (size_t)g * rcap);
  if (threadIdx.x < 8) {
    const int v[3] = {n, n_runs, n >= capm ? 1 : 0};
    gmeta[(size_t)g * 8 + threadIdx.x] = threadIdx.x < 3 ? v[threadIdx.x] : 0;
  }
}

}  // namespace

extern "C" int mpr_compact_runs(const void* cmeta, const void* words,
                                const void* imms, const void* order,
                                const void* remap, const void* codes,
                                void* tw, void* ti, void* runs, void* gmeta,
                                int gcap, int n_tiles, int tw_words, int tcap,
                                int cap, int rcap, void* stream) {
  int threads = ((tw_words + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const size_t shmem = (size_t)(rcap + 1) * sizeof(int) + (size_t)cap;
  cudaError_t err = cudaFuncSetAttribute(
      compact_runs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shmem);
  if (err != cudaSuccess) return (int)err;
  compact_runs_kernel<<<gcap, threads, shmem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cmeta), static_cast<const uint32_t*>(words),
      static_cast<const int*>(imms), static_cast<const int*>(order),
      static_cast<const int*>(remap), static_cast<const uint32_t*>(codes),
      static_cast<int*>(tw), static_cast<int*>(ti), static_cast<int*>(runs),
      static_cast<int*>(gmeta), n_tiles, tw_words, tcap, cap, rcap);
  return (int)cudaGetLastError();
}
