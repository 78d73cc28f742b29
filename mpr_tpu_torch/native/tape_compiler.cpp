// Native tape compiler: the hot passes of mpr_tpu_torch/tape/tape.py in C++.
//
// A copy of the JAX package's mpr_tpu/native/tape_compiler.cpp, which may
// differ from it only in comments (tests/test_torch_native.py compares the
// two with comments and blank lines stripped).
//
// The reference's tape compiler is host C++ (reference/src/tape.cpp).  The
// Python frontend flattens the hash-consed expression DAG to post-order
// arrays, and this library performs liveness analysis, opcode-run
// scheduling (see tape.py::_schedule_opruns), linear-scan slot allocation
// with free-list reuse, and constant folding into immediates — semantically
// identical to the Python passes (tests/test_torch_native.py asserts
// bit-equality).  Its speed against them is measured, not assumed: PERF.md.
//
// Pure C ABI, loaded with ctypes.

#include <cstdint>
#include <cstring>
#include <vector>
#include <deque>
#include <unordered_map>

namespace {

// Frontend op-family ids (must match mpr_tpu_torch/native/__init__.py::_FAMILY).
enum Family : int32_t {
  F_CONST = 0, F_X = 1, F_Y = 2, F_Z = 3,
  F_SQUARE = 4, F_SQRT = 5, F_NEG = 6, F_SIN = 7, F_COS = 8,
  F_ASIN = 9, F_ACOS = 10, F_ATAN = 11, F_EXP = 12, F_ABS = 13, F_LOG = 14,
  F_ADD = 15, F_MUL = 16, F_MIN = 17, F_MAX = 18,
  F_SUB = 19, F_DIV = 20,
  F_HYPOT = 21, F_ADDSQ = 22,   // fused compound ops (tape/fuse.py)
};

// GPU opcodes (mpr_tpu_torch/tape/opcodes.py, mirroring
// reference/inc/gpu_opcode.hpp:18-56).
enum Op : int32_t {
  INVALID = 0, JUMP = 1,
  SQUARE_LHS = 2, SQRT_LHS = 3, NEG_LHS = 4, SIN_LHS = 5, COS_LHS = 6,
  ASIN_LHS = 7, ACOS_LHS = 8, ATAN_LHS = 9, EXP_LHS = 10, ABS_LHS = 11,
  LOG_LHS = 12,
  ADD_LHS_IMM = 13, ADD_LHS_RHS = 14, MUL_LHS_IMM = 15, MUL_LHS_RHS = 16,
  MIN_LHS_IMM = 17, MIN_LHS_RHS = 18, MAX_LHS_IMM = 19, MAX_LHS_RHS = 20,
  SUB_LHS_IMM = 21, SUB_IMM_RHS = 22, SUB_LHS_RHS = 23,
  DIV_LHS_IMM = 24, DIV_IMM_RHS = 25, DIV_LHS_RHS = 26,
  COPY_IMM = 27, COPY_LHS = 28, COPY_RHS = 29,
  HYPOT_LHS_RHS = 30, ADDSQ_LHS_RHS = 31,
};

constexpr int32_t SLOT_CAP = 224;

struct Node {
  int32_t fam;
  int32_t lhs, rhs;   // indices into the post-order array, -1 if none
  float value;
};

inline bool is_unary(int32_t f) { return f >= F_SQUARE && f <= F_LOG; }
inline bool is_comm(int32_t f) { return f >= F_ADD && f <= F_MAX; }
inline bool is_noncomm(int32_t f) { return f == F_SUB || f == F_DIV; }
inline bool is_fused(int32_t f) { return f == F_HYPOT || f == F_ADDSQ; }
inline int32_t fused_gpu(int32_t f) {
  return f == F_HYPOT ? HYPOT_LHS_RHS : ADDSQ_LHS_RHS;
}

int32_t unary_gpu(int32_t f) { return SQUARE_LHS + (f - F_SQUARE); }

void comm_gpu(int32_t f, int32_t* imm_form, int32_t* reg_form) {
  switch (f) {
    case F_ADD: *imm_form = ADD_LHS_IMM; *reg_form = ADD_LHS_RHS; return;
    case F_MUL: *imm_form = MUL_LHS_IMM; *reg_form = MUL_LHS_RHS; return;
    case F_MIN: *imm_form = MIN_LHS_IMM; *reg_form = MIN_LHS_RHS; return;
    default:    *imm_form = MAX_LHS_IMM; *reg_form = MAX_LHS_RHS; return;
  }
}

void noncomm_gpu(int32_t f, int32_t* lhs_imm, int32_t* imm_rhs,
                 int32_t* reg_form) {
  if (f == F_SUB) {
    *lhs_imm = SUB_LHS_IMM; *imm_rhs = SUB_IMM_RHS; *reg_form = SUB_LHS_RHS;
  } else {
    *lhs_imm = DIV_LHS_IMM; *imm_rhs = DIV_IMM_RHS; *reg_form = DIV_LHS_RHS;
  }
}

// _gpu_op_of equivalent (tape.py:122-138), imm-folding aware.
int32_t gpu_op_of(const std::vector<Node>& nodes, int32_t i) {
  const Node& c = nodes[i];
  if (is_unary(c.fam)) return unary_gpu(c.fam);
  if (is_fused(c.fam)) return fused_gpu(c.fam);
  bool lc = c.lhs >= 0 && nodes[c.lhs].fam == F_CONST;
  bool rc = c.rhs >= 0 && nodes[c.rhs].fam == F_CONST;
  if (is_comm(c.fam)) {
    int32_t imm_form, reg_form;
    comm_gpu(c.fam, &imm_form, &reg_form);
    return (lc || rc) ? imm_form : reg_form;
  }
  int32_t lhs_imm, imm_rhs, reg_form;
  noncomm_gpu(c.fam, &lhs_imm, &imm_rhs, &reg_form);
  if (lc) return imm_rhs;
  if (rc) return lhs_imm;
  return reg_form;
}

// tape.py::_schedule_opruns — greedy windowed same-opcode run scheduling.
// `nodes` here are the compute nodes only (consts/vars filtered), with lhs/
// rhs still pointing into the FULL post-order array; `full_to_fast` maps
// full indices to compute indices (-1 otherwise).
std::vector<int32_t> schedule_opruns(
    const std::vector<Node>& full, const std::vector<int32_t>& fast,
    const std::vector<int32_t>& full_to_fast, int window) {
  const int n = (int)fast.size();
  std::vector<int> ndeps(n, 0);
  std::vector<std::vector<int>> consumers(n);
  for (int i = 0; i < n; ++i) {
    const Node& c = full[fast[i]];
    for (int32_t h : {c.lhs, c.rhs}) {
      if (h >= 0) {
        int32_t j = full_to_fast[h];
        if (j >= 0) { ndeps[i]++; consumers[j].push_back(i); }
      }
    }
  }
  // Per-opcode ready queues.  key_order tracks first-insertion order so
  // tie-breaking matches Python's max() over dict iteration (insertion)
  // order — keeps native and Python tapes bit-identical.
  std::deque<int> ready[64];
  std::vector<int32_t> key_order;
  bool seen_key[64] = {false};
  std::vector<char> inqueue(n, 0), scheduled(n, 0);
  std::vector<int32_t> opof(n);
  for (int i = 0; i < n; ++i) opof[i] = gpu_op_of(full, fast[i]);

  auto push = [&](int i) {
    if (!inqueue[i]) {
      int32_t k = opof[i];
      if (!seen_key[k]) { seen_key[k] = true; key_order.push_back(k); }
      ready[k].push_back(i);
      inqueue[i] = 1;
    }
  };
  int frontier = 0;
  for (int i = 0; i < std::min(window, n); ++i)
    if (ndeps[i] == 0) push(i);

  std::vector<int32_t> out;
  out.reserve(n);
  int32_t cur = -1;
  while ((int)out.size() < n) {
    if (cur < 0 || ready[cur].empty()) {
      // opcode with the most ready clauses; first-inserted wins ties
      size_t best = 0;
      int32_t best_k = -1;
      for (int32_t k : key_order) {
        if (ready[k].size() > best) { best = ready[k].size(); best_k = k; }
      }
      cur = best_k;
      if (cur < 0) return {};  // cycle: cannot happen on a DAG
    }
    int i = ready[cur].front();
    ready[cur].pop_front();
    out.push_back(i);
    scheduled[i] = 1;
    for (int j : consumers[i]) {
      if (--ndeps[j] == 0 && j < frontier + window) push(j);
    }
    int old_f = frontier;
    while (frontier < n && scheduled[frontier]) frontier++;
    for (int j = old_f + window; j < std::min(frontier + window, n); ++j)
      if (ndeps[j] == 0 && !scheduled[j]) push(j);
  }
  return out;
}

}  // namespace

extern "C" {

// Returns 0 on success, -1 slot overflow, -2 internal error.
// o_meta: [length, num_slots, sx, sy, sz, result_slot, num_choices, window]
int mpr_compile(const int32_t* fams, const int32_t* lhs, const int32_t* rhs,
                const float* values, int32_t n,
                int32_t use_opruns, int32_t window,
                int32_t* o_ops, int32_t* o_outs, int32_t* o_lhss,
                int32_t* o_rhss, float* o_imms, int32_t* o_meta) {
  std::vector<Node> full(n);
  for (int i = 0; i < n; ++i)
    full[i] = Node{fams[i], lhs[i], rhs[i], values[i]};

  // liveness skeleton + axis detection (tape.py:212-233)
  int32_t axes[3] = {-1, -1, -1};
  std::vector<int32_t> fast;
  std::vector<int32_t> full_to_fast(n, -1);
  for (int i = 0; i < n; ++i) {
    int32_t f = full[i].fam;
    if (f == F_CONST) continue;
    if (f == F_X) { axes[0] = i; continue; }
    if (f == F_Y) { axes[1] = i; continue; }
    if (f == F_Z) { axes[2] = i; continue; }
    full_to_fast[i] = (int32_t)fast.size();
    fast.push_back(i);
  }

  std::vector<int32_t> order;  // indices into `fast`
  if (use_opruns && window > 0) {
    order = schedule_opruns(full, fast, full_to_fast, window);
    if (order.size() != fast.size()) return -2;
  } else {
    order.resize(fast.size());
    for (size_t i = 0; i < fast.size(); ++i) order[i] = (int32_t)i;
  }

  // last consumer in FINAL order (tape.py:256-261), keyed by full index
  std::vector<int32_t> last_used(n, -1);
  for (int32_t oi : order) {
    const Node& c = full[fast[oi]];
    if (c.rhs >= 0) last_used[c.rhs] = fast[oi];
    last_used[c.lhs] = fast[oi];
  }

  // slot allocation (tape.py:263-292)
  std::vector<int32_t> free_slots;
  std::vector<int32_t> bound(n, -1);
  int32_t num_slots = 1;
  auto get_slot = [&](int32_t node) -> int32_t {
    int32_t s;
    if (!free_slots.empty()) { s = free_slots.back(); free_slots.pop_back(); }
    else {
      if (num_slots >= SLOT_CAP) return -1;
      s = num_slots++;
    }
    bound[node] = s;
    return s;
  };

  int32_t axis_slots[3] = {0, 0, 0};
  for (int a = 0; a < 3; ++a)
    if (axes[a] >= 0) {
      int32_t s = get_slot(axes[a]);
      if (s < 0) return -1;
      axis_slots[a] = s;
    }

  int32_t num_choices = 0;
  int32_t len = 0;
  for (int32_t oi : order) {
    int32_t fi = fast[oi];
    const Node& c = full[fi];
    int32_t o_op = 0, o_l = 0, o_r = 0;
    float o_i = 0.f;
    bool lc = c.lhs >= 0 && full[c.lhs].fam == F_CONST;
    bool rc = c.rhs >= 0 && full[c.rhs].fam == F_CONST;
    if (is_unary(c.fam)) {
      o_op = unary_gpu(c.fam);
      o_l = bound[c.lhs];
      if (o_l < 0) return -2;
    } else if (is_fused(c.fam)) {
      o_op = fused_gpu(c.fam);
      o_l = bound[c.lhs];
      o_r = bound[c.rhs];
      if (o_l < 0 || o_r < 0) return -2;
    } else if (is_comm(c.fam)) {
      int32_t imm_form, reg_form;
      comm_gpu(c.fam, &imm_form, &reg_form);
      if (lc)      { o_op = imm_form; o_l = bound[c.rhs]; o_i = full[c.lhs].value; }
      else if (rc) { o_op = imm_form; o_l = bound[c.lhs]; o_i = full[c.rhs].value; }
      else         { o_op = reg_form; o_l = bound[c.lhs]; o_r = bound[c.rhs]; }
      if (o_l < 0 || o_r < 0) return -2;
      if (c.fam == F_MIN || c.fam == F_MAX) num_choices++;
    } else if (is_noncomm(c.fam)) {
      int32_t lhs_imm, imm_rhs, reg_form;
      noncomm_gpu(c.fam, &lhs_imm, &imm_rhs, &reg_form);
      if (lc)      { o_op = imm_rhs; o_r = bound[c.rhs]; o_i = full[c.lhs].value; }
      else if (rc) { o_op = lhs_imm; o_l = bound[c.lhs]; o_i = full[c.rhs].value; }
      else         { o_op = reg_form; o_l = bound[c.lhs]; o_r = bound[c.rhs]; }
      if (o_l < 0 || o_r < 0) return -2;
    } else {
      return -2;
    }

    // free operand slots at last use BEFORE allocating the output
    // (in-place reuse, reference/src/tape.cpp:199-210).  RHS first
    // so the LIFO pop gives the output the LHS slot -> in-place COPY_LHS
    // elision during shortening (must match tape.py exactly).
    int32_t freed[2] = {-1, -1};
    int nf = 0;
    for (int32_t h : {c.rhs, c.lhs}) {
      if (h >= 0 && full[h].fam != F_CONST && last_used[h] == fi) {
        bool dup = false;
        for (int k = 0; k < nf; ++k) if (freed[k] == h) dup = true;
        if (!dup && bound[h] >= 0) {
          free_slots.push_back(bound[h]);
          bound[h] = -1;
          freed[nf++] = h;
        }
      }
    }
    int32_t o_o = get_slot(fi);
    if (o_o < 0) return -1;
    o_ops[len] = o_op; o_outs[len] = o_o; o_lhss[len] = o_l;
    o_rhss[len] = o_r; o_imms[len] = o_i;
    len++;
  }

  // result slot (tape.py:346-359)
  int32_t root = n - 1;
  int32_t result_slot;
  if (full[root].fam == F_CONST) {
    int32_t s = get_slot(root);
    if (s < 0) return -1;
    o_ops[len] = COPY_IMM; o_outs[len] = s; o_lhss[len] = 0;
    o_rhss[len] = 0; o_imms[len] = full[root].value;
    len++;
    result_slot = s;
  } else {
    result_slot = bound[root];
    if (result_slot < 0) return -2;
  }

  o_meta[0] = len;
  o_meta[1] = num_slots;
  o_meta[2] = axis_slots[0];
  o_meta[3] = axis_slots[1];
  o_meta[4] = axis_slots[2];
  o_meta[5] = result_slot;
  o_meta[6] = num_choices;
  o_meta[7] = window;
  return 0;
}

}  // extern "C"
