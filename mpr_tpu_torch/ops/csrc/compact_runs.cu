// Kernel C1: tape compaction straight from kernel A's shorten codes, with
// opcode-run headers.
//
// Replaces: mpr_tpu/ops/kernels.py::compact_runs (Pallas body
// `_compact_kernel`), the first public version of kernel C: no prepass,
// the shared tape and each tile's packed 4-bit codes in, a dense per-tile
// tape out whose words keep the OPCODE in their low byte (kernel C's hold
// the branch id).
//
// Bound on the H100: bytes on paper, latency in practice.  A row reads its
// tile's code words (tcap / 2 bytes) and, for each kept clause, a tape
// word and an immediate (8 bytes, shared by every row, so they come from
// L2), and writes 8 bytes per kept clause plus the run headers: a few KB a
// row, well under a microsecond of the card's bandwidth even at a few
// hundred rows, so each row's chain of dependent steps (the codes' load,
// the scan, the tape's loads, the run numbering, the stores) sets the time.
// The first design took a block a row with a thread per code word (1024
// threads at an 8192-clause plane), walked each thread's words one nibble
// at a time with a dependent tape load per kept clause, ran three
// block-wide barriers' worth of scans and stored 4 bytes at a time.
//
// Design: the launch shapes and the run numbering of kernels C and C2
// (compact_core.cuh: Group, number_runs), at a shape picked on the host
// (ops/launch.py::compact_runs_launch): a warp a row, several rows a
// block, for short planes (tcap <= C_WARP_TCAP: only __syncwarp and
// shuffles); a block a row of 128 to C_BLOCK_THREADS threads for long
// ones, a thread for each 16-byte load of code words (32 clauses).  The
// loads a row needs first (cmeta, its order entry, the remap table) are
// issued together, with no barrier before them.  Per row:
//   1. each thread loads four code words in one 16-byte load (4-byte loads
//      where the rows are not 16-byte aligned), turns them into a mask of
//      32 clauses (a bit per non-zero nibble) and counts them with __popc;
//      the group's exclusive sum (shuffles, and one block scan in the
//      block-a-row shape) gives the place of its first kept clause.  A
//      clause is kept iff its nibble is non-zero and fewer than `cap`
//      non-zero nibbles come before it; its place is that count.  Each
//      kept clause's index and nibble go to shared memory at its place (no
//      global load here).  Planes longer than the group's loads take
//      several rounds, whose scans alternate between two scratch buffers.
//   2. each thread takes four places at a time, so every thread has the
//      same few tape loads in flight whatever the codes' clustering: it
//      reads the four clauses' words and immediates (from L2: every row
//      shares the tape), rewrites them
//        COPY_LHS on a two-operand op     -> rhs := lhs      (min(a, a) == a)
//        COPY_LHS on MIN/MAX_LHS_IMM      -> imm := +inf / -inf
//        COPY_RHS                         -> lhs := rhs
//        COPY_IMM                         -> opcode COPY_IMM (the one run
//                                            breaker)
//      and stores them to tw and ti in one 16-byte store each (4-byte ones
//      where the row's length is not a multiple of 4; the quad that holds
//      len is zero past it), and their branch ids remap[new_op] to shared
//      memory;
//   3. number_runs numbers the runs of the staged branch ids;
//   4. the headers over [0, n_runs) go out in 16-byte stores.
// Edges kept from the TPU kernel: len = min(count, cap) and overflow is
// `len >= cap`, so a tape of exactly cap clauses is flagged; the codes are
// not masked by the tape's length (cmeta[1] words are walked); cmeta[2]
// may lie below the outputs' cap.  Nothing past len or n_runs is
// specified and nothing is zero-filled there.  gmeta[g] = [len, n_runs,
// overflow, 0..].  Rows g >= cmeta[0], and rows whose order entry names no
// tile, are left as allocated.

#include "clause.cuh"
#include "compact_core.cuh"

namespace {

using namespace mpr;

// One bit a clause of a code word: bit j set where nibble j is non-zero.
__device__ __forceinline__ uint32_t nibble_mask(uint32_t cw) {
  uint32_t m = (cw | (cw >> 1) | (cw >> 2) | (cw >> 3)) & 0x11111111u;
  m = (m | (m >> 3)) & 0x03030303u;
  m = (m | (m >> 6)) & 0x000F000Fu;
  return (m | (m >> 12)) & 0xFFu;
}

// Shared bytes of one row that stages at most `stage` kept clauses: a
// clause entry (t | nib << 16) a place, the run starts (stage + 1 ints)
// and a branch id a place; a multiple of 16.  (Host twin:
// ops/launch.py::c1_row_bytes.)
__host__ __device__ inline int c1_row_bytes(int stage) {
  const int s4 = (stage + 3) & ~3;
  return 4 * (2 * s4 + 4) + ((stage + 15) & ~15);
}

// The rewritten word of clause word `word` under nibble `nib`, its
// immediate's bits (in: the tape's) and its opcode.
__device__ __forceinline__ uint32_t rewrite(uint32_t word, int nib,
                                            int* imm, int* new_op) {
  const int op = w_op(word), lhs = w_lhs(word), rhs = w_rhs(word);
  const bool is_min_imm = op == OP_MIN_IMM, is_max_imm = op == OP_MAX_IMM;
  const bool imm_form = is_min_imm || is_max_imm;
  const bool take_rhs = nib == CODE_COPY_RHS;
  const int new_lhs = take_rhs ? rhs : lhs;
  const int new_rhs = (nib == CODE_COPY_LHS && !imm_form) ? lhs : rhs;
  *new_op = nib == CODE_COPY_IMM ? (int)OP_COPY_IMM : op;
  if (nib == CODE_COPY_LHS && imm_form)
    *imm = is_min_imm ? 0x7f800000 : (int)0xff800000u;
  return (uint32_t)*new_op | (word & 0xFF00u) | ((uint32_t)new_lhs << 16)
         | ((uint32_t)new_rhs << 24);
}

// A minimum of one block a multiprocessor: without it ptxas held the
// block-a-row instantiation to 32 registers and spilled.
template <bool WARP>
__global__ void __launch_bounds__(1024, 1)
compact_runs_kernel(
    const int* __restrict__ cmeta,       // [n_groups, n_words, cap, ..]
    const uint32_t* __restrict__ words,  // (tcap,) shared tape
    const int* __restrict__ imm_bits,    // (tcap,) f32 bits
    const int* __restrict__ order,       // (>= gcap,)
    const int* __restrict__ remap,       // (32,) op -> branch id
    const uint32_t* __restrict__ codes,  // (n_tiles, tw_words)
    int* __restrict__ tw, int* __restrict__ ti, int* __restrict__ runs,
    int* __restrict__ gmeta, int gcap, int n_tiles, int tw_words, int tcap,
    int cap, int rcap, int stage) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int scratch[64];
  __shared__ int sremap[32];
  const int lane = threadIdx.x & 31;
  const int slot = WARP ? (int)(threadIdx.x >> 5) : 0;
  const int g = blockIdx.x * (WARP ? (int)(blockDim.x >> 5) : 1) + slot;
  // every load a row needs before its codes, issued together
  const int rm = __ldg(remap + lane);
  const int n_groups = cmeta[0], cm1 = cmeta[1], cm2 = cmeta[2];
  const int tile = g < gcap ? order[g] : -1;
  if (g >= min(gcap, n_groups)) return;
  if (tile < 0 || tile >= n_tiles) return;   // a bad order entry: no access
  const int n_words = max(0, min(min(cm1, tw_words), tcap / 8));
  const int capm = max(0, min(cm2, cap));

  const int s4 = (stage + 3) & ~3;
  unsigned char* buf = smem + (size_t)slot * c1_row_bytes(stage);
  int* sidx = reinterpret_cast<int*>(buf);
  int* sstart = sidx + s4;                          // stage + 1 <= s4 + 4
  unsigned char* sbid = reinterpret_cast<unsigned char*>(sstart + s4 + 4);

  const uint32_t* cw = codes + (size_t)tile * tw_words;
  const bool vec = (tw_words & 3) == 0
                   && (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  const int nq = (n_words + 3) >> 2;
  const int me = WARP ? lane : (int)threadIdx.x;
  const int P = WARP ? 32 : (int)blockDim.x;

  // ---- 1. count and place the kept clauses: 32 a thread a round -----------
  int total = 0;  // non-zero nibbles of the rounds so far
  for (int q0 = 0, round = 0; q0 < nq; q0 += P, ++round) {
    const Group<WARP> grp(scratch + 32 * (round & 1));
    const int q = q0 + me;
    uint32_t c[4] = {0u, 0u, 0u, 0u};
    if (q < nq) {
      if (vec) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(cw) + q);
        c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (4 * q + j < n_words) c[j] = __ldg(cw + 4 * q + j);
      }
      // words past n_words (the last quad of the walk) are not walked
#pragma unroll
      for (int j = 1; j < 4; ++j)
        if (4 * q + j >= n_words) c[j] = 0u;
    }
    uint32_t mask = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) mask |= nibble_mask(c[j]) << (8 * j);
    int sum;
    int k = total + grp.exclusive_sum(__popc(mask), &sum);
    total += sum;
    // each kept clause's index and nibble go to its place
    for (; mask != 0 && k < capm; ++k) {
      const int b = __ffs(mask) - 1;
      mask &= mask - 1;
      const uint32_t cb = (b & 16) ? ((b & 8) ? c[3] : c[2])
                                   : ((b & 8) ? c[1] : c[0]);
      sidx[k] = (32 * q + b) | (int)(((cb >> (4 * (b & 7))) & 15) << 16);
    }
  }
  sremap[lane] = rm;  // every warp writes the same table
  const Group<WARP> grp(scratch);
  grp.sync();

  // ---- 2. load, rewrite and store the kept clauses, four places a thread --
  const int n = min(total, capm);
  int* tw_g = tw + (size_t)g * cap;
  int* ti_g = ti + (size_t)g * cap;
  const bool vec_out = (cap & 3) == 0;
  for (int q = me; 4 * q < n; q += P) {
    const int4 e4 = *reinterpret_cast<const int4*>(sidx + 4 * q);
    const int e[4] = {e4.x, e4.y, e4.z, e4.w};
    uint32_t wd[4];
    int im[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool on = 4 * q + j < n;
      wd[j] = on ? __ldg(words + (e[j] & 0xFFFF)) : 0u;
      im[j] = on ? __ldg(imm_bits + (e[j] & 0xFFFF)) : 0;
    }
    int ow[4], oi[4];
    uint32_t bids = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int op = 0;
      ow[j] = (int)rewrite(wd[j], e[j] >> 16, &im[j], &op);
      oi[j] = im[j];
      if (4 * q + j >= n) ow[j] = oi[j] = 0;
      bids |= (uint32_t)sremap[min(op, NUM_OPS - 1)] << (8 * j);
    }
    *reinterpret_cast<uint32_t*>(sbid + 4 * q) = bids;
    if (vec_out) {
      reinterpret_cast<int4*>(tw_g)[q] = make_int4(ow[0], ow[1], ow[2], ow[3]);
      reinterpret_cast<int4*>(ti_g)[q] = make_int4(oi[0], oi[1], oi[2], oi[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (4 * q + j < n) {
          tw_g[4 * q + j] = ow[j];
          ti_g[4 * q + j] = oi[j];
        }
      }
    }
  }
  grp.sync();

  // ---- 3. the runs of the staged branch ids --------------------------------
  const int n_runs = number_runs(grp, sbid, n, sstart, stage);
  grp.sync();

  // ---- 4. the run headers and gmeta ----------------------------------------
  int* runs_g = runs + (size_t)g * rcap;
  const int nr = min(n_runs, rcap);
  auto header = [&](int r) -> int {
    if (r >= nr) return 0;
    const int s = sstart[r];
    const int e = r + 1 < n_runs ? sstart[r + 1] : n;
    return (int)sbid[s] | ((e - s) << 8);
  };
  if ((rcap & 3) == 0) {
    for (int q = me; 4 * q < nr; q += P) {
      const int r = 4 * q;
      reinterpret_cast<int4*>(runs_g)[q] =
          make_int4(header(r), header(r + 1), header(r + 2), header(r + 3));
    }
  } else {
    for (int r = me; r < nr; r += P) runs_g[r] = header(r);
  }
  if (me < 2)
    reinterpret_cast<int4*>(gmeta + (size_t)g * 8)[me] =
        me == 0 ? make_int4(n, n_runs, n >= capm ? 1 : 0, 0)
                : make_int4(0, 0, 0, 0);
}

}  // namespace

// threads a block, group the threads a row (32: a warp a row; threads: a
// block a row), smem the dynamic shared memory the host computed for the
// shape (ops/launch.py::compact_runs_launch, which also checks it): a row
// stages at most min(cap, tcap) clauses.
extern "C" int mpr_compact_runs(const void* cmeta, const void* words,
                                const void* imms, const void* order,
                                const void* remap, const void* codes,
                                void* tw, void* ti, void* runs, void* gmeta,
                                int gcap, int n_tiles, int tw_words, int tcap,
                                int cap, int rcap, int threads, int group,
                                int smem, void* stream) {
  const int stage = cap < tcap ? cap : tcap;
  if (cap < 1 || rcap < 1 || tcap < 1 || tcap > 65536 || tw_words < 0 ||
      threads % 32 || threads > 1024 || (group != 32 && group != threads) ||
      smem != threads / group * c1_row_bytes(stage))
    return (int)cudaErrorInvalidValue;
  const bool warp = group == 32;
  auto fn = warp ? compact_runs_kernel<true> : compact_runs_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = threads / group;
  fn<<<(gcap + rows - 1) / rows, threads, smem,
       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cmeta), static_cast<const uint32_t*>(words),
      static_cast<const int*>(imms), static_cast<const int*>(order),
      static_cast<const int*>(remap), static_cast<const uint32_t*>(codes),
      static_cast<int*>(tw), static_cast<int*>(ti), static_cast<int*>(runs),
      static_cast<int*>(gmeta), gcap, n_tiles, tw_words, tcap, cap, rcap,
      stage);
  return (int)cudaGetLastError();
}
