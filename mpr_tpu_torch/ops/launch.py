"""Launch shapes of the interpreter kernels, picked on the host.

Kernels B, V and D (``csrc/pixel_eval.cu``, ``voxel_eval.cu``,
``deriv_eval.cu``) share the register file of ``csrc/regfile.cuh``: where
it lives (shared or local memory, or for D split by warps), threads a
block, items a thread (K), blocks a row (P) and dynamic shared memory make
a :class:`Launch`.  Kernel A (``csrc/interval_shorten.cu``) walks a tape's
dependency levels with a block or a thread a tile: threads a block, tiles
a block and whether the schedule's planes are staged in shared memory make
an :class:`IntervalLaunch`.  Kernels C and C2 (``csrc/compact.cu``,
``compact_order.cu``) take a row with a warp or with the whole block: threads
a block, threads a row and dynamic shared memory make a
:class:`CompactLaunch`.

Kernel K2 (``csrc/scan_adjoint.cu``, the interpreter's adjoint) keeps an
adjoint file a lane in one of the two homes: home, threads, lanes a thread
(K) and dynamic shared memory make an :class:`AdjointLaunch`.  Kernel K2f
(``csrc/scan_eval.cu``, the interpreter's forward walk) keeps the file of
its re-slotted walk in shared memory: threads and K make a
:class:`ScanLaunch`.  The generated unrolled evaluators
(``ops/unrolled_eval.py``) run in one of three forms, an
:class:`UnrolledLaunch`.

Every function here is pure host code; the pickers are
:func:`interval_launch`, :func:`pixel_launch`, :func:`compact_launch`,
:func:`adjoint_launch` and :func:`scan_launch` (kernels A, B, C and C2,
K2 and K2f),
:func:`unrolled_launch` (the generated evaluators) and
``kernels3d.voxel_launch`` / ``deriv_launch`` (V and D).  A caller may force another shape (``launch=``
of a wrapper), which the wrapper checks.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace

SMEM_LIMIT = 232_448     # dynamic shared memory a block may use (H100)
SM_SHARED = 233_472      # shared memory of an SM; each block reserves 1 KB
SM_COUNT = 132
SM_THREADS = 2048
# branch table, camera matrix, V's table of world coordinates, the work
# queue's counter (csrc/regfile.cuh)
SMEM_HEADER = 4 * (256 + 16 + 48 + 4)
THREADS = (512, 256, 128, 64)
KS = (1, 2, 4)
PARTS = (1, 2, 4, 8, 16, 32, 64)
BUCKETS = (16, 32, 64, 128, 256)
B_SHARED = (256, 4)      # B, files in shared memory: threads, K
B_LOCAL = (256, 2)       # B, files in local memory: threads, K
ADJ_SHARED = (128, 2)    # K2, adjoint files in shared memory: threads, K
ADJ_LOCAL = (128, 2)     # K2, adjoint files in local memory: threads, K
# B and D stage an overflowed row's full tape in shared memory where it
# takes at most this
STAGE_MAX = 65_536
# B: waves of blocks its grid should hold at least, so that the block
# scheduler can even out tiles of unequal length
B_WAVES = 4
# K of the instantiations in the main library, by kernel, for the shared
# home (bucket 0) and for local files (a bucket): the shapes the launch
# functions pick.  The extra library holds the other K (ops/build.py;
# csrc/pixel_eval.cu, voxel_eval.cu, deriv_eval.cu, scan_adjoint.cu:
# kernel<K, N>()).
MAIN_K = {"pixel_eval_runs": (B_SHARED[1], B_LOCAL[1]),
          "voxel_eval_3d": (4, 2),
          "deriv_eval_3d": (1, 1),
          "scan_adjoint": (ADJ_SHARED[1], ADJ_LOCAL[1])}


@dataclass(frozen=True)
class Launch:
    """One launch shape of kernel B, V or D.

    ``home``: where the register files live: ``"shared"`` (every warp's in
    shared memory), ``"local"`` (in local memory) or, for D only,
    ``"split"`` (the first ``shared_warps`` warps' in shared memory, the
    others' in local memory); ``threads`` a block; ``k`` items (pixels,
    voxels) a thread runs at once; ``blocks_per_row`` (P; 1 for V) blocks
    share a row's 4096 items; ``smem`` dynamic shared bytes; ``bucket`` the
    local files' slots (0 when no warp has one); ``stage_full``: B and D
    stage an overflowed row's full tape in shared memory."""
    home: str
    threads: int
    k: int
    blocks_per_row: int
    smem: int
    bucket: int = 0
    stage_full: bool = False
    shared_warps: int = 0


def local_bucket(s_cap: int) -> int:
    """The local home's slot count for ``s_cap``: 16, 32, 64, 128 or 256."""
    for b in BUCKETS:
        if b >= s_cap:
            return b
    raise ValueError(f"s_cap {s_cap} over {BUCKETS[-1]}")


def library(kernel: str, launch: Launch) -> str:
    """The library (ops/build.py) that holds ``kernel`` at ``launch``."""
    return ("main" if launch.k == MAIN_K[kernel][launch.bucket != 0]
            else "extra")


def _tape_bytes(entries: int) -> int:
    """Shared bytes of a staged tape of ``entries`` clauses (words,
    immediates, run headers), padded to 16 bytes."""
    return 4 * ((3 * entries + 3) & ~3)


def _resident(smem: int, threads: int) -> int:
    """Blocks an SM holds as far as shared memory and threads go."""
    return min(SM_SHARED // (smem + 1024), SM_THREADS // threads)


def _shape(home, threads, k, s_cap, slot_bytes, fixed, shared_warps=0,
           stage_full=False, parts=1) -> Launch:
    """The Launch of a home, threads, K, P and (split home) shared warps:
    ``fixed`` shared bytes besides the files, a shared file of
    ``slot_bytes`` x s_cap x k x 32 bytes a warp, and the bucket."""
    sw = {"shared": threads // 32, "local": 0}.get(home, shared_warps or 0)
    return Launch(home, threads, k, parts,
                  fixed + slot_bytes * s_cap * k * 32 * sw,
                  0 if home == "shared" else local_bucket(s_cap), stage_full,
                  sw)


def _most_shared_warps(threads, k, s_cap, slot_bytes, fixed, smem_limit):
    """Most warps of a split block whose files fit beside ``fixed`` bytes
    (at least one warp keeps a local file)."""
    per_warp = slot_bytes * s_cap * k * 32
    return max(0, min(threads // 32 - 1, (smem_limit - fixed) // per_warp))


def _check_shape(launch: Launch, smem_limit: int, max_threads: int = 512,
                 homes=("shared", "split", "local")):
    """Raise unless ``launch`` is one the kernels can run: a home of
    ``homes`` that agrees with its shared warps, K and P in their sets,
    whole chunks of 32 x K items for every warp, shared bytes within the
    limit."""
    warps = launch.threads // 32
    agrees = {"shared": launch.shared_warps == warps,
              "local": launch.shared_warps == 0,
              "split": 0 < launch.shared_warps < warps}
    if (launch.home not in homes or not agrees[launch.home]
            or launch.k not in KS
            or launch.threads not in THREADS
            or launch.threads > max_threads
            or launch.blocks_per_row not in PARTS
            or 4096 % (32 * launch.k * launch.blocks_per_row)
            or launch.threads * launch.k * launch.blocks_per_row > 4096
            or launch.smem > smem_limit):
        raise ValueError(f"launch shape {launch} does not fit "
                         f"({smem_limit} shared bytes)")
    return launch


def _fill_parts(launch: Launch, n_rows: int, waves: int = 1) -> int:
    """P for ``n_rows`` rows: the smallest power of two that gives the grid
    at least ``waves`` times as many blocks as the card holds at once (and
    at least two an SM), at most one chunk a thread."""
    target = max(2 * SM_COUNT,
                 waves * SM_COUNT * _resident(launch.smem, launch.threads))
    most = 4096 // (launch.threads * launch.k)
    parts = 1
    while parts < most and 0 < n_rows * parts < target:
        parts *= 2
    return parts


# ---------------------------------------------------------------------------
# Kernel B
# ---------------------------------------------------------------------------

def _pixel_fixed(cap, tcap, stage_full):
    return SMEM_HEADER + _tape_bytes(max(cap, tcap) if stage_full else cap)


@functools.lru_cache(maxsize=256)
def pixel_launch(s_cap: int, cap: int, n_rows: int, tcap: int,
                 smem_limit: int = SMEM_LIMIT, *, home: str = None,
                 threads: int = None, k: int = None, parts: int = None,
                 stage_full: bool = None) -> Launch:
    """Kernel B's launch shape for slot bucket ``s_cap``, row capacity
    ``cap``, ``n_rows`` rows (every tile: the ambiguous count stays on the
    card) and a full tape of ``tcap`` clauses.

    Where the files of ``B_SHARED`` (threads, K) fit in shared memory and
    leave an SM two blocks, they live there (a short tape); otherwise in
    local memory, ``B_LOCAL`` (threads, K) (a long tape: the shared home
    holds too few pixels an SM to hide its latency).  An overflowed row's
    full tape is staged in shared memory where it takes at most
    ``STAGE_MAX`` bytes and fits.  P, the blocks a tile, is the smallest
    power of two that gives the grid ``B_WAVES`` waves of blocks
    (:func:`_fill_parts`), so that tiles of unequal length spread over many
    blocks.  ``home``, ``threads``,
    ``k``, ``parts`` and ``stage_full`` force a shape; a forced shape that
    does not fit raises.  (Kept: the wrapper asks at every launch.)"""
    def shape(h, t, kk):
        stage = stage_full
        if stage is None:
            stage = (_tape_bytes(tcap) <= STAGE_MAX and _shape(
                h, t, kk, s_cap, 4, _pixel_fixed(cap, tcap, True)).smem
                <= smem_limit)
        return _shape(h, t, kk, s_cap, 4, _pixel_fixed(cap, tcap, stage), 0,
                      stage)

    if home is None and threads is None and k is None:
        launch = shape("shared", *B_SHARED)
        if launch.smem > min(smem_limit, SM_SHARED // 2 - 1024):
            launch = shape("local", *B_LOCAL)
    else:
        home = home or "shared"
        k = k or (B_SHARED if home == "shared" else B_LOCAL)[1]
        if threads is None:
            if home == "shared":
                fits = [t for t in THREADS if t * k <= 4096
                        and shape(home, t, k).smem <= smem_limit]
                threads = fits[0] if fits else THREADS[-1]
            else:
                threads = B_LOCAL[0] * B_LOCAL[1] // k
        launch = shape(home, threads, k)
    if parts is None:
        parts = _fill_parts(launch, n_rows, B_WAVES)
    return _check_shape(replace(launch, blocks_per_row=parts), smem_limit,
                        homes=("shared", "local"))


def check_pixel_launch(launch: Launch, s_cap: int, cap: int,
                       tcap: int) -> Launch:
    """A caller's ``launch`` of kernel B, checked: a shape the kernel can
    run, whose bucket, shared bytes and staging are the ones its home,
    threads, K and P give."""
    want = _shape(launch.home, launch.threads, launch.k, s_cap, 4,
                  _pixel_fixed(cap, tcap, launch.stage_full), 0,
                  launch.stage_full, launch.blocks_per_row)
    _check_shape(launch, SMEM_LIMIT, homes=("shared", "local"))
    if launch != want:
        raise ValueError(f"launch shape {launch} is not {want}")
    return launch


# ---------------------------------------------------------------------------
# Kernel A
# ---------------------------------------------------------------------------

A_THREADS = (32, 64, 128, 256, 512, 1024)
A_OWN_THREADS = (64, 128, 256)   # a thread a tile: threads (tiles) a block
# Threads an SM keeps busy before more of them slow each step (kernel A's
# cost model; fitted to the launch-shape sweep of chip_smoke.py on an H100)
A_BUSY_THREADS = 1024
A_PLANES = 4             # schedule planes: word, src, mark, t


@dataclass(frozen=True)
class IntervalLaunch:
    """One launch shape of kernel A: ``threads`` a block, ``tiles`` a
    block (1: the block walks one tile; ``threads``: a thread a tile),
    ``stage``: the schedule's planes are copied into shared memory first;
    ``smem`` dynamic shared bytes."""
    threads: int
    tiles: int
    stage: bool
    smem: int

    @property
    def group(self) -> int:
        """Threads that walk one tile."""
        return self.threads // self.tiles


def padded_length(length: int) -> int:
    """Entries of a schedule plane and of a tile's arrays: the tape's
    length rounded up to 16 (so that every array starts on 16 bytes)."""
    return max(16, -(-length // 16) * 16)


def a_tile_bytes(length: int) -> int:
    """Shared bytes of one tile in kernel A: an interval (8 B), a choice,
    an active flag and a code (1 B each) per clause."""
    return 11 * padded_length(length)


def a_plane_bytes(length: int) -> int:
    """Shared bytes of the staged schedule planes."""
    return 4 * A_PLANES * padded_length(length)


def _a_shape(length, threads, tiles, stage) -> IntervalLaunch:
    return IntervalLaunch(threads, tiles, bool(stage),
                          (a_plane_bytes(length) if stage else 0)
                          + tiles * a_tile_bytes(length))


def _check_a(launch: IntervalLaunch, length: int, smem_limit: int):
    if (launch.threads not in A_THREADS
            or launch.tiles not in (1, launch.threads)
            or launch != _a_shape(length, launch.threads, launch.tiles,
                                  launch.stage)
            or launch.smem > smem_limit):
        raise ValueError(f"kernel A launch shape {launch} does not fit a "
                         f"tape of {length} clauses ({smem_limit} shared "
                         "bytes)")
    return launch


def _a_steps(widths, group):
    """Steps a tile's group of ``group`` threads takes over levels of
    ``widths`` clauses, each way: a level's clauses ``group`` at a time,
    and one more step a level for its barrier (none for a thread a tile,
    which needs no barrier)."""
    if group == 1:
        return sum(widths)
    return sum(-(-w // group) + 1 for w in widths)


def _a_resident(launch: IntervalLaunch) -> int:
    """Tiles an SM runs at once as far as shared memory, threads and the
    card's 32 blocks an SM go."""
    blocks = min(SM_SHARED // (launch.smem + 1024), SM_THREADS //
                 launch.threads, 32)
    return blocks * launch.tiles


def _a_cost(launch: IntervalLaunch, widths, lanes: int) -> float:
    """Kernel A's cost model: (steps a tile) x (waves of tiles over the
    card), each step slowed in proportion once an SM holds more than
    ``A_BUSY_THREADS`` threads."""
    resident = _a_resident(launch)
    waves = -(-max(lanes, 1) // (SM_COUNT * resident))
    busy = resident * launch.group / A_BUSY_THREADS
    return waves * _a_steps(widths, launch.group) * max(1.0, busy)


@functools.lru_cache(maxsize=256)
def _pick_a(widths, lanes, smem_limit):
    """The default shape of :func:`interval_launch` (kept: the wrapper asks
    for it at every launch)."""
    length = sum(widths)
    cands = []
    for n in A_OWN_THREADS:
        # a thread a tile: the planes, read by every tile of the block,
        # staged in shared memory where they fit beside the tiles
        staged = _a_shape(length, n, n, True)
        cands.append(staged if staged.smem <= smem_limit
                     else _a_shape(length, n, n, False))
    cands += [_a_shape(length, g, 1, False) for g in A_THREADS[1:]]
    best = None
    for c in cands:
        if c.smem > smem_limit:
            continue
        cost = _a_cost(c, widths, lanes)
        if best is None or cost < best[0]:
            best = (cost, c)
    return best[1]


def interval_launch(widths, lanes: int, smem_limit: int = SMEM_LIMIT, *,
                    threads: int = None, tiles: int = None,
                    stage: bool = None) -> IntervalLaunch:
    """Kernel A's launch shape for a tape whose dependency levels hold
    ``widths`` clauses each (``TapeLevels.widths``), over ``lanes`` tiles.

    A tile's group of threads takes a level's clauses side by side: a wide
    group finishes a wide level in fewer steps, a narrow one leaves room
    for more tiles an SM.  The candidates are a block a tile (64 to 1024
    threads, the planes read from global memory) and a thread a tile
    (``A_OWN_THREADS`` tiles a block, the planes staged in shared memory
    where they fit); the pick is the one of least :func:`_a_cost` ((steps
    a tile) x (waves of tiles over the card), a step slower when an SM
    holds many threads), the first on a tie.  ``threads``, ``tiles`` (1, or
    ``threads`` for a thread a tile) and ``stage`` force a shape; a forced
    shape that does not fit raises, and so does a tape whose one tile does
    not fit in shared memory."""
    widths = tuple(int(w) for w in widths)
    length = sum(widths)
    per_tile = a_tile_bytes(length)
    if per_tile > smem_limit:
        raise ValueError(f"a tape of {length} clauses needs {per_tile} "
                         f"shared bytes a tile in kernel A, over the "
                         f"{smem_limit} a block may have")
    if threads is None and tiles is None and stage is None:
        return _check_a(_pick_a(widths, int(lanes), smem_limit), length,
                        smem_limit)
    tiles = tiles or 1
    if threads is None:
        threads = tiles if tiles > 1 else 256
    if stage is None:
        stage = tiles > 1 and (a_plane_bytes(length) + tiles * per_tile
                               <= smem_limit)
    return _check_a(_a_shape(length, threads, tiles, stage), length,
                    smem_limit)


def check_interval_launch(launch: IntervalLaunch,
                          length: int) -> IntervalLaunch:
    """A caller's ``launch`` of kernel A, checked: threads and tiles the
    kernel takes (a block a tile, or a thread a tile), the shared bytes
    that its tiles and staging give for ``length`` clauses, within the
    limit."""
    return _check_a(launch, length, SMEM_LIMIT)


# ---------------------------------------------------------------------------
# Kernels C and C2
# ---------------------------------------------------------------------------

C_THREADS = (32, 64, 128, 256, 512, 1024)
# planes of at most this many clauses take a warp a row, longer ones a
# block a row
C_WARP_TCAP = 1024
C_WARP_ROWS = 8          # rows (warps) a block at most, a warp a row
# a block a row: words of the plane a thread, and threads a block at most.
# Fewer threads a row leave an SM more rows in flight (48 registers a
# thread: 5 blocks of 256 an SM, 1 of 1024), which the launch-shape sweep
# of chip_smoke.py found faster at every long-plane cell.
C_WORDS = 16
C_BLOCK_THREADS = 512


@dataclass(frozen=True)
class CompactLaunch:
    """One launch shape of kernel C or C2: ``threads`` a block, ``group``
    the threads that take one row (32: a warp a row, ``threads // 32``
    rows a block; ``threads``: a block a row), ``smem`` dynamic shared
    bytes (:func:`c_row_bytes` a row)."""
    threads: int
    group: int
    smem: int

    @property
    def rows(self) -> int:
        """Rows a block."""
        return self.threads // self.group


def c_row_bytes(tcap: int, cap: int) -> int:
    """Shared bytes of one row in kernels C and C2 (``csrc/
    compact_core.cuh::compact_row_bytes``): the staged words and immediates
    (cap rounded up to 4, each), the run starts (cap + 1 ints in cap
    rounded up to 4, plus 4) and a branch id a clause of the plane."""
    cap4 = -(-cap // 4) * 4
    return 4 * (3 * cap4 + 4) + -(-tcap // 16) * 16


def _c_shape(tcap, cap, threads, warp) -> CompactLaunch:
    group = 32 if warp else threads
    return CompactLaunch(threads, group,
                         threads // group * c_row_bytes(tcap, cap))


def _check_c(launch: CompactLaunch, tcap: int, cap: int, smem_limit: int):
    if (launch.threads not in C_THREADS
            or launch.group not in (32, launch.threads)
            or launch != _c_shape(tcap, cap, launch.threads,
                                  launch.group == 32)
            or launch.smem > smem_limit):
        raise ValueError(f"kernel C launch shape {launch} does not fit a "
                         f"{tcap}-clause plane at cap {cap} ({smem_limit} "
                         "shared bytes)")
    return launch


@functools.lru_cache(maxsize=256)
def compact_launch(tcap: int, cap: int, n_rows: int,
                   smem_limit: int = SMEM_LIMIT, *, warp: bool = None,
                   threads: int = None) -> CompactLaunch:
    """Kernel C's (and C2's) launch shape for planes of ``tcap`` clauses,
    per-row capacity ``cap`` and ``n_rows`` rows.

    A plane of at most ``C_WARP_TCAP`` clauses takes a warp a row (a row is
    too short to keep a block busy; a warp needs no block barrier, and an
    SM holds many rows at once), with up to ``C_WARP_ROWS`` rows a block,
    fewer where the grid would then leave SMs idle or the rows' shared
    memory would not fit.  A longer plane takes a block a row, with a
    thread for every ``C_WORDS`` words (128 to ``C_BLOCK_THREADS``
    threads).  ``warp`` and ``threads`` force a shape; a forced shape that
    does not fit raises.  (Kept: the wrappers ask at every launch.)"""
    if warp is None:
        warp = tcap <= C_WARP_TCAP
    if threads is None:
        if warp:
            rows = C_WARP_ROWS
            while rows > 1 and (-(-n_rows // rows) < SM_COUNT
                                or rows * c_row_bytes(tcap, cap)
                                > smem_limit):
                rows //= 2
            threads = 32 * rows
        else:
            threads = min(C_BLOCK_THREADS, max(128, tcap // C_WORDS))
    return _check_c(_c_shape(tcap, cap, threads, warp), tcap, cap,
                    smem_limit)


def check_compact_launch(launch: CompactLaunch, tcap: int,
                         cap: int) -> CompactLaunch:
    """A caller's ``launch`` of kernel C or C2, checked: threads the kernel
    takes, a warp or the block a row, the shared bytes that its rows give
    for ``tcap`` and ``cap``, within the limit."""
    return _check_c(launch, tcap, cap, SMEM_LIMIT)


# ---------------------------------------------------------------------------
# The generated unrolled evaluators (ops/unrolled_eval.py, csrc/unrolled.cuh)
# ---------------------------------------------------------------------------

# Threads a block of the lanes and serial forms.
UNROLLED_THREADS = 128
# Lanes a thread (K) the lanes form is built at, by semantics, and the K
# the picker takes for a tape bound by operations and for one bound by its
# lanes' bytes (``short``: at most ``OPS_PER_BYTE`` float operations a
# byte a lane moves); warps a block (P) the split form is built at, and
# the P the picker takes; the warps an SM a lanes launch must give for the
# picker to take it (a "wave" below).  Chosen by the sweep of forced forms
# on an H100 (chip_smoke.py phase 13, device time; PERF.md): K = 1 was the
# fastest lanes form on the extruded tape's 9.3 M float lanes (2.31 ms
# against 2.55 at K = 2 and 2.87 at K = 4) and its 0.66 M interval lanes,
# K = 2 on the 22-clause gyroid's 2^26 float lanes (0.50 against 0.56 at
# K = 1).  A small lanes launch takes about as long as each scheduler
# fetching the whole tape's code (K = 2: 0.082 ms on 512 interval lanes,
# 0.086 on 20,928), which the split form shares among an SM's four
# schedulers (P = 8: 0.013 and 0.021); P = 8 beat P = 4 and 32 at the 2D
# cell's 256 and 15,552 lanes (0.022 and 0.040 ms against 0.036 / 0.024
# and 0.043 / 0.105).  8 warps an SM (33,792 lanes) lies between the
# cells' largest split launch (20,928) and their smallest lanes launch
# (148,352).
UNROLLED_KS = {"float": (1, 2, 4), "interval": (1, 2)}
UNROLLED_K = {"float": 1, "interval": 1}
UNROLLED_K_SHORT = {"float": 2, "interval": 1}
OPS_PER_BYTE = 10.0      # 33.5e12 float32 operations a second / 3.35e12 B
UNROLLED_PARTS = (4, 8, 32)
UNROLLED_P = 8
UNROLLED_WAVE_WARPS = 8
UNROLLED_WAVE = SM_COUNT * UNROLLED_WAVE_WARPS * 32


@dataclass(frozen=True)
class UnrolledLaunch:
    """One form of a generated evaluator: ``"lanes"`` (the scheduled
    statements, ``k`` lanes a thread, resident blocks of
    ``UNROLLED_THREADS`` walking the lanes), ``"split"`` (the tape cut
    among up to ``parts`` warps of a block, 32 lanes a block) or
    ``"serial"`` (the statements in tape order, a thread a lane: the
    deriv kernel, K1's forward half, and the float and interval kernels'
    first design)."""
    form: str
    k: int = 1
    parts: int = 1

    @property
    def tag(self) -> str:
        """The form's part of a library's key."""
        return {"lanes": f"lanes-k{self.k}", "split": f"split-p{self.parts}",
                "serial": "serial"}[self.form]


def unrolled_defaults(kind: str, short: bool = False):
    """The forms :func:`unrolled_launch` may pick for a ``kind`` evaluator
    (of a ``short`` tape): what the evaluator builds."""
    if kind not in UNROLLED_KS:
        return [UnrolledLaunch("serial")]
    k = (UNROLLED_K_SHORT if short else UNROLLED_K)[kind]
    return [UnrolledLaunch("split", parts=UNROLLED_P),
            UnrolledLaunch("lanes", k=k)]


def check_unrolled_launch(launch: UnrolledLaunch, kind: str):
    """A caller's form of a ``kind`` evaluator, checked: the deriv kernel
    and K1's forward half are serial only; the lanes form at a K its kind
    is built at, the split form at P in ``UNROLLED_PARTS``."""
    ok = {"serial": launch.k == 1 and launch.parts == 1,
          "lanes": (kind in UNROLLED_KS and launch.parts == 1
                    and launch.k in UNROLLED_KS[kind]),
          "split": (kind in UNROLLED_KS and launch.k == 1
                    and launch.parts in UNROLLED_PARTS)}
    if not ok.get(launch.form, False):
        raise ValueError(f"unrolled launch {launch} does not fit a {kind} "
                         "evaluator")
    return launch


def unrolled_launch(n: int, kind: str, short: bool = False, *,
                    form: str = None, k: int = None,
                    parts: int = None) -> UnrolledLaunch:
    """The form of a ``kind`` evaluator's launch over ``n`` lanes (of a
    ``short`` tape: one bound by its lanes' bytes).

    Float and interval: under ``UNROLLED_WAVE`` lanes the split form at
    ``UNROLLED_P`` warps (a thread walking the whole tape would leave the
    card nearly empty, each scheduler fetching all of its code), else the
    lanes form at ``UNROLLED_K[kind]`` (``UNROLLED_K_SHORT`` for a short
    tape).  Other kinds: serial.  ``form``, ``k`` and ``parts`` force a
    form (tests and chip_smoke.py); one that does not fit raises."""
    if form is None and k is None and parts is None:
        forms = unrolled_defaults(kind, short)
        return forms[0] if len(forms) > 1 and n < UNROLLED_WAVE else forms[-1]
    if form is None:
        form = "split" if parts is not None else (
            "lanes" if kind in UNROLLED_KS else "serial")
    if form == "lanes" and k is None:
        k = (UNROLLED_K_SHORT if short else UNROLLED_K).get(kind, 1)
    if form == "split" and parts is None:
        parts = UNROLLED_P
    return check_unrolled_launch(UnrolledLaunch(form, k or 1, parts or 1),
                                 kind)


# ---------------------------------------------------------------------------
# Kernel K2, the interpreter's adjoint (csrc/scan_adjoint.cu)
# ---------------------------------------------------------------------------

ADJ_TILE = 256           # tape entries of a staged tile (two buffers)
ADJ_ENTRY_BYTES = 16     # word, immediate, operand codes, result/choice
ADJ_THREADS = (64, 128, 256)
# K (lanes a thread) K2 is built at (at K = 1 ptxas spilled a few bytes)
ADJ_KS = (2, 4)
# blocks of a K2 launch at most (its grid-stride loop takes the rest), and
# so the rows of its partial sums
ADJ_BLOCKS = 1024


@dataclass(frozen=True)
class AdjointLaunch:
    """One launch shape of kernel K2: ``home`` of the adjoint files
    (``"shared"`` or ``"local"``), ``threads`` a block, ``k`` lanes a
    thread, ``smem`` dynamic shared bytes (the immediates' accumulator,
    two staged tiles of the tape and, in the shared home, the files),
    ``bucket`` the local files' slots (0 in the shared home)."""
    home: str
    threads: int
    k: int
    smem: int
    bucket: int = 0

    @property
    def lanes(self) -> int:
        """Lanes a block takes at once."""
        return self.threads * self.k


def adj_fixed(length: int) -> int:
    """Shared bytes of K2 besides the files: an accumulator float a clause
    (padded to 16 bytes) and two tiles of ``ADJ_TILE`` entries."""
    return 16 * -(-4 * max(length, 1) // 16) + 2 * ADJ_TILE * ADJ_ENTRY_BYTES


def _adj_shape(home, threads, k, s_cap, length) -> AdjointLaunch:
    files = 4 * s_cap * k * threads if home == "shared" else 0
    return AdjointLaunch(home, threads, k, adj_fixed(length) + files,
                         0 if home == "shared" else local_bucket(s_cap))


def _check_adj(launch: AdjointLaunch, s_cap: int, length: int,
               smem_limit: int) -> AdjointLaunch:
    if (launch.home not in ("shared", "local") or launch.k not in ADJ_KS
            or launch.threads not in ADJ_THREADS
            or launch != _adj_shape(launch.home, launch.threads, launch.k,
                                    s_cap, length)
            or launch.smem > smem_limit):
        raise ValueError(f"kernel K2 launch shape {launch} does not fit "
                         f"s_cap {s_cap} and a {length}-clause tape "
                         f"({smem_limit} shared bytes)")
    return launch


def adjoint_launch(s_cap: int, length: int, smem_limit: int = SMEM_LIMIT,
                   *, home: str = None, threads: int = None,
                   k: int = None) -> AdjointLaunch:
    """Kernel K2's launch shape for slot bucket ``s_cap`` (the adjoint
    file's slots) and a tape of ``length`` clauses.

    Where the files of ``ADJ_SHARED`` (threads, K) fit in shared memory
    beside the accumulator and the staged tiles and leave an SM two
    blocks, they live there (a short tape); otherwise in local memory,
    ``ADJ_LOCAL`` (threads, K), a bucket of 16 to 256 slots, where all the
    lanes of a fit stay resident at once and each clause's three adjoint
    reads are in flight together (at the scan fit's 176 slots the local
    home is the faster one: ``chip_smoke.py`` phase 14's K2 sweep,
    PERF.md).  ``home``, ``threads`` and ``k`` force a
    shape, the missing parts chosen as above; a forced shape that does
    not fit raises, and so does a tape whose accumulator alone does
    not."""
    if adj_fixed(length) > smem_limit:
        raise ValueError(f"a {length}-clause tape needs {adj_fixed(length)} "
                         f"shared bytes in kernel K2, over {smem_limit}")
    if home is None and threads is None and k is None:
        sh = _adj_shape("shared", *ADJ_SHARED, s_cap, length)
        if sh.smem <= min(smem_limit, SM_SHARED // 2 - 1024):
            return sh
        return _check_adj(_adj_shape("local", *ADJ_LOCAL, s_cap, length),
                          s_cap, length, smem_limit)
    home = home or "shared"
    k = k or (ADJ_SHARED if home == "shared" else ADJ_LOCAL)[1]
    if threads is None:
        threads = (ADJ_SHARED if home == "shared" else ADJ_LOCAL)[0]
        if home == "shared":
            fits = [t for t in reversed(ADJ_THREADS) if _adj_shape(
                home, t, k, s_cap, length).smem <= smem_limit]
            threads = fits[0] if fits else ADJ_THREADS[0]
    return _check_adj(_adj_shape(home, threads, k, s_cap, length), s_cap,
                      length, smem_limit)


def check_adjoint_launch(launch: AdjointLaunch, s_cap: int,
                         length: int) -> AdjointLaunch:
    """A caller's ``launch`` of kernel K2, checked: a home, threads and K
    the kernel takes, whose shared bytes and bucket are the ones they give
    for ``s_cap`` and ``length``, within the limit."""
    return _check_adj(launch, s_cap, length, SMEM_LIMIT)


# ---------------------------------------------------------------------------
# Kernel K2f, the interpreter's forward walk (csrc/scan_eval.cu)
# ---------------------------------------------------------------------------

SCAN_TILE = 256          # walk entries of a staged tile (two buffers)
SCAN_ENTRY_BYTES = 16    # word, immediate, store codes, flags
# threads an SM a launch of more lanes keeps busy before the picker takes
# more lanes a thread
SCAN_SM_THREADS = 1024


@dataclass(frozen=True)
class ScanLaunch:
    """One launch shape of kernel K2f: ``threads`` a block, ``k`` lanes a
    thread, the file (``ops/scan_plan.py``: its slots, K floats a slot a
    thread) in shared memory beside two staged tiles of the walk and a
    spare entry."""
    threads: int
    k: int

    @property
    def lanes(self) -> int:
        """Lanes a block takes at once."""
        return self.threads * self.k

    def smem(self, slots: int) -> int:
        """Dynamic shared bytes for a file of ``slots`` slots."""
        return ((2 * SCAN_TILE + 1) * SCAN_ENTRY_BYTES
                + 4 * max(slots, 1) * self.k * self.threads)


# Every shape K2f takes (K = 1 and 4 are built, in the main library;
# threads are a launch argument): what chip_smoke.py's sweep and the card
# tests run.  The picker takes K = 1 for a launch that leaves an SM fewer
# than ``SCAN_SM_THREADS`` threads at K = 4, else K = 4, and the threads
# that let an SM hold the most warps beside their files (128 at a tie).
# The sweep on an H100 at 700 W (chip_smoke.py phase 15, PERF.md): K = 4
# ran the 2^20- and 2^22-lane brute launches of stress_2d(600) and (1500)
# in 0.4-0.5x K = 1's time, K = 1 the scan fit's storing launch of
# 65,536 lanes in 0.84-0.92x K = 4's; at stress_2d(1500)'s 24 slots, 256
# threads (16 warps an SM) took 0.83x 128's (12 warps).
SCAN_SWEEP = tuple(ScanLaunch(t, k) for k in (1, 4) for t in (128, 256))


def check_scan_launch(launch: ScanLaunch, slots: int) -> ScanLaunch:
    """A caller's ``launch`` of kernel K2f, checked: a shape of
    ``SCAN_SWEEP`` whose file of ``slots`` slots fits in shared memory."""
    if launch not in SCAN_SWEEP or launch.smem(slots) > SMEM_LIMIT:
        raise ValueError(f"kernel K2f launch shape {launch} is not one of "
                         f"SCAN_SWEEP or does not fit a file of {slots} "
                         "slots")
    return launch


def scan_launch(slots: int, n: int, *, threads: int = None,
                k: int = None) -> ScanLaunch:
    """Kernel K2f's launch shape for a file of ``slots`` slots (the
    re-slotted walk's live peak) over ``n`` lanes: K = 4 lanes a thread
    where ``n`` leaves every SM ``SCAN_SM_THREADS`` threads at K = 4, else
    K = 1 (a short launch needs its warps to hide each clause's latency),
    at the threads of ``SCAN_SWEEP`` under which an SM holds the most
    warps (128 at a tie); a file too large for K = 4 takes K = 1.
    ``threads`` and ``k`` force a shape of ``SCAN_SWEEP`` (the missing
    part as above); one outside it raises."""
    if threads is None and k is None:
        big = n >= 4 * SM_COUNT * SCAN_SM_THREADS
        for kk in ((4, 1) if big else (1,)):
            fits = [s for s in SCAN_SWEEP
                    if s.k == kk and s.smem(slots) <= SMEM_LIMIT]
            if fits:
                return max(fits, key=lambda s: (_resident(
                    s.smem(slots), s.threads) * s.threads, -s.threads))
        raise ValueError(f"kernel K2f has no shape for a file of {slots} "
                         "slots")
    return check_scan_launch(ScanLaunch(threads or 128, k or 1), slots)


def scan_blocks(launch: ScanLaunch, slots: int, n: int) -> int:
    """Blocks of a K2f launch over ``n`` lanes: one a block's lanes, at
    most as many as the card holds at once (each walks its lanes in a
    grid-stride loop)."""
    resident = max(1, _resident(launch.smem(slots), launch.threads))
    return max(1, min(-(-n // launch.lanes), SM_COUNT * resident))
