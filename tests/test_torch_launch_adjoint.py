"""PyTorch port: the launch shapes of kernel K2, the interpreter's adjoint
(pure host code).

``adjoint_launch`` picks where K2's adjoint files live (shared memory or a
local array of the slot bucket), the threads of a block and the lanes a
thread takes (K), and the dynamic shared memory that takes: the
immediates' accumulator, two staged tiles of the tape and, in the shared
home, the files.  For every slot bucket and tape length the fit path can
give, each shape must fit the card's shared memory, name a bucket that
holds the tape's slots, and use K and threads the kernel is built for;
forced shapes must be accepted where they fit and refused otherwise.  No
JAX is imported.
"""

import pytest

torch = pytest.importorskip("torch")

from mpr_tpu_torch.ops import eval_scan
from mpr_tpu_torch.ops import launch as ln

S_CAPS = list(range(8, 257, 8))
LENGTHS = [22, 369, 2727, 5373, 13365]


def _check(launch, s_cap, length):
    assert launch.smem <= ln.SMEM_LIMIT == 232_448
    assert launch.k in ln.ADJ_KS == (2, 4)
    assert launch.threads in ln.ADJ_THREADS and launch.threads % 32 == 0
    fixed = ln.adj_fixed(length)
    assert fixed >= 4 * length + 2 * ln.ADJ_TILE * 16
    if launch.home == "shared":
        assert launch.bucket == 0
        assert launch.smem == fixed + 4 * s_cap * launch.k * launch.threads
    else:
        assert launch.home == "local"
        assert launch.smem == fixed
        assert launch.bucket in ln.BUCKETS
        assert launch.bucket >= s_cap and launch.bucket < 2 * max(s_cap, 16)
    assert ln.check_adjoint_launch(launch, s_cap, length) == launch


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("s_cap", S_CAPS)
def test_adjoint_launch_fits(s_cap, length):
    """The picked shape fits, and takes the shared home exactly where its
    block leaves an SM two (a short tape)."""
    launch = ln.adjoint_launch(s_cap, length)
    _check(launch, s_cap, length)
    shared = ln._adj_shape("shared", *ln.ADJ_SHARED, s_cap, length)
    want = ("shared" if shared.smem <= ln.SM_SHARED // 2 - 1024
            else "local")
    assert launch.home == want
    assert (launch.threads, launch.k) == (ln.ADJ_SHARED if want == "shared"
                                          else ln.ADJ_LOCAL)
    assert ln.library("scan_adjoint", launch) == "main"


@pytest.mark.parametrize("home", ["shared", "local"])
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("threads", [None, 64, 128, 256])
@pytest.mark.parametrize("s_cap,length", [(16, 22), (176, 5373),
                                          (256, 13365)])
def test_forced_adjoint_shapes(home, k, threads, s_cap, length):
    """A forced home, K and threads is taken where it fits and refused
    where its shared memory would pass the limit."""
    files = 4 * s_cap * k * (threads or 0) if home == "shared" else 0
    if home == "shared" and threads is not None and (
            ln.adj_fixed(length) + files > ln.SMEM_LIMIT):
        with pytest.raises(ValueError, match="does not fit"):
            ln.adjoint_launch(s_cap, length, home=home, k=k, threads=threads)
        return
    if home == "shared" and threads is None and ln.adj_fixed(length) + (
            4 * s_cap * k * ln.ADJ_THREADS[0]) > ln.SMEM_LIMIT:
        with pytest.raises(ValueError, match="does not fit"):
            ln.adjoint_launch(s_cap, length, home=home, k=k)
        return
    launch = ln.adjoint_launch(s_cap, length, home=home, k=k,
                               threads=threads)
    _check(launch, s_cap, length)
    assert (launch.home, launch.k) == (home, k)
    if threads is not None:
        assert launch.threads == threads
    assert ln.library("scan_adjoint", launch) == ("main" if k == 2
                                                   else "extra")


@pytest.mark.parametrize("bad", [
    dict(home="split"), dict(k=1), dict(k=3), dict(threads=96),
    dict(threads=512),
    dict(home="shared", k=4, threads=256)])
def test_unrunnable_adjoint_shapes_are_refused(bad):
    with pytest.raises(ValueError, match="does not fit"):
        ln.adjoint_launch(176, 5373, **bad)


def test_a_tampered_adjoint_shape_is_refused():
    launch = ln.adjoint_launch(176, 5373)
    for wrong in (dict(smem=launch.smem + 16), dict(bucket=128),
                  dict(home="shared")):
        with pytest.raises(ValueError, match="does not fit"):
            ln.check_adjoint_launch(
                ln.AdjointLaunch(**{**launch.__dict__, **wrong}), 176, 5373)
    # and a tape whose accumulator alone passes the limit
    with pytest.raises(ValueError, match="shared bytes"):
        ln.adjoint_launch(16, 60_000)


def test_the_fit_tapes_get_their_designed_k2_shapes():
    """The scan fit's tape (stress_2d(600): 173 slots, 5,373 clauses) and
    the extruded one (174 slots) keep their files in local memory, a
    bucket of 256 slots (in shared memory an SM would hold one block);
    the gyroid's (10 slots) in shared memory."""
    for s_cap, length in ((176, 5373), (176, 2727), (256, 13365)):
        pick = ln.adjoint_launch(s_cap, length)
        assert (pick.home, pick.threads, pick.k, pick.bucket) == (
            "local", *ln.ADJ_LOCAL, 256)
    small = ln.adjoint_launch(16, 22)
    assert (small.home, small.threads, small.k) == ("shared",
                                                    *ln.ADJ_SHARED)


def test_adjoint_s_cap_rounds_the_slots_up_to_eight():
    class TD:
        num_slots = 173
    assert eval_scan.adjoint_s_cap(TD) == 176
    TD.num_slots = 3
    assert eval_scan.adjoint_s_cap(TD) == 8
