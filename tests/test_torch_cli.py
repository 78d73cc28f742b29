"""PyTorch port: ``python -m mpr_tpu_torch.cli`` on the CPU, in process.

Every registered sub-command runs for real with ``--device cpu`` at sizes
of 64 to 128 (the timed ones with the run counts cut to one frame), and
what it prints and writes is held against ``mpr_tpu.cli`` on the same
source where that takes no long XLA compile: the lines of ``dump-tape``
and ``shorten-stats``, the PNG of ``render2d``, the four PNGs of
``render3d``, the archive of ``convert``.

Tolerance.  PNGs of exact images (fill, depth) must be equal byte for
byte.  Normals, SSAO and the shaded image are floats scaled to 8 bits, so a
last-place difference can move a pixel across a grey level: they must
agree within 1 level on at least 99% of the pixels (the test prints the
share).
"""

import pytest

torch = pytest.importorskip("torch")

import pathlib

import numpy as np

from mpr_tpu import cli as jcli
from mpr_tpu.frontend import frep as jfrep
from mpr_tpu.tape.tape import compile_tree as jcompile_tree

import mpr_tpu_torch
from mpr_tpu_torch import cli
from mpr_tpu_torch.frontend import frep, shapes
from mpr_tpu_torch.io.png import read_png_gray
from mpr_tpu_torch.utils import timing

from torch_port_cases import one_torch_thread  # noqa: F401

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
TEXT_DEMO = str(EXAMPLES / "text_demo.io")
CPU = ["--device", "cpu"]


@pytest.fixture
def one_frame(monkeypatch):
    """The tables' protocol (5 + 50 frames) cut to one warm-up and one
    timed frame."""
    real = timing.time_frames
    monkeypatch.setattr(
        timing, "time_frames",
        lambda frame, *a, n=1, n0=1: real(frame, *a, n=1, n0=1))


@pytest.fixture(scope="module")
def scene_frep(tmp_path_factory):
    p = tmp_path_factory.mktemp("scene") / "two_spheres.frep"
    frep.dump([frep.ArchiveShape(tree=shapes.two_spheres(), name="s")],
              str(p))
    return str(p)


def _rgb(path):
    """Decode an 8-bit RGB(A) PNG written by io/png.py (no filter)."""
    import struct
    import zlib
    data = pathlib.Path(path).read_bytes()
    w, h, depth, ctype = struct.unpack(">IIBB", data[16:26])
    assert depth == 8 and ctype in (2, 6)
    ch = 3 if ctype == 2 else 4
    pos, idat = 8, b""
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        if tag == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + w * ch)
    assert not raw[:, 0].any()
    return raw[:, 1:].reshape(h, w, ch)


# ---- render2d -----------------------------------------------------------------

def test_render2d_stress_equals_the_jax_cli(tmp_path, capsys):
    a, b = tmp_path / "t.png", tmp_path / "j.png"
    cli.main(["render2d", "stress:12", "--size", "128", "--check", "--out",
              str(a)] + CPU)
    out = capsys.readouterr().out
    assert "oracle cross-check: mismatch 0.00e+00" in out
    jcli.main(["render2d", "stress:12", "--size", "128", "--out", str(b)])
    assert a.read_bytes() == b.read_bytes()
    img = read_png_gray(str(a))
    assert img.shape == (128, 128) and set(np.unique(img)) == {0, 255}


def test_render2d_io_scene_and_brute(tmp_path, capsys):
    a, b = tmp_path / "a.png", tmp_path / "b.png"
    cli.main(["render2d", TEXT_DEMO, "--size", "128", "--check", "--out",
              str(a)] + CPU)
    assert "mismatch 0.00e+00" in capsys.readouterr().out
    cli.main(["render2d", TEXT_DEMO, "--size", "128", "--brute", "--out",
              str(b)] + CPU)
    assert a.read_bytes() == b.read_bytes()
    assert 0.01 < (read_png_gray(str(a)) > 0).mean() < 0.9


def test_render2d_set_overrides_a_named_var(tmp_path):
    src = str(EXAMPLES / "parametric.io")
    a, b = tmp_path / "a.png", tmp_path / "b.png"
    cli.main(["render2d", src, "--size", "64", "--out", str(a)] + CPU)
    cli.main(["render2d", src, "--size", "64", "--set", "radius=0.45",
              "--out", str(b)] + CPU)
    assert (read_png_gray(str(b)) > 0).sum() < (read_png_gray(str(a))
                                                > 0).sum()
    with pytest.raises(SystemExit, match="unknown var"):
        cli.main(["render2d", src, "--size", "64", "--set", "nope=1",
                  "--out", str(b)] + CPU)


def test_render2d_check_failure_exits(tmp_path, monkeypatch):
    from mpr_tpu_torch import oracle
    monkeypatch.setattr(oracle, "eval_f",
                        lambda tape, x, y, z=None: np.ones_like(x))
    with pytest.raises(SystemExit, match="FAIL: .* pixels differ"):
        cli.main(["render2d", "stress:12", "--size", "64", "--check",
                  "--out", str(tmp_path / "a.png")] + CPU)


# ---- render3d -----------------------------------------------------------------

def test_render3d_all_modes_against_the_jax_cli(tmp_path, scene_frep):
    t, j = tmp_path / "t.png", tmp_path / "j.png"
    # 128: the JAX pipeline needs two 64-voxel tiles a side
    args = ["render3d", scene_frep, "--size", "128", "--mode", "all",
            "--view", "gui"]
    cli.main(args + ["--out", str(t)] + CPU)
    jcli.main(args + ["--out", str(j)])
    names = [f"{base}_{s}.png" for base in ("t", "j")
             for s in ("depth", "norm", "ssao", "shaded")]
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(names)
    assert (tmp_path / "t_depth.png").read_bytes() == \
        (tmp_path / "j_depth.png").read_bytes()
    depth = read_png_gray(str(tmp_path / "t_depth.png"))
    assert 0.05 < (depth > 0).mean() < 0.95
    for s in ("ssao", "shaded"):
        a = read_png_gray(str(tmp_path / f"t_{s}.png")).astype(int)
        b = read_png_gray(str(tmp_path / f"j_{s}.png")).astype(int)
        share = (np.abs(a - b) <= 1).mean()
        print(f"{s}: {share:.4%} of pixels within 1 grey level")
        assert share >= 0.99
    a, b = (_rgb(tmp_path / f"{x}_norm.png").astype(int) for x in "tj")
    share = (np.abs(a - b) <= 1).all(axis=-1).mean()
    print(f"normals: {share:.4%} of pixels within 1 grey level")
    assert a.shape == (128, 128, 3) and share >= 0.99
    shaded = read_png_gray(str(tmp_path / "t_shaded.png"))
    assert not shaded[depth == 0].any()
    assert shaded[depth > 0].min() >= int(0.2 * 255) - 1


@pytest.mark.parametrize("mode,suffixes", [("heightmap", ["depth"]),
                                           ("normals", ["norm"]),
                                           ("ssao", ["ssao"]),
                                           ("shaded", ["shaded"])])
def test_render3d_single_modes(tmp_path, mode, suffixes):
    cli.main(["render3d", "stress:12", "--size", "64", "--mode", mode,
              "--out", str(tmp_path / "o.png")] + CPU)
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        [f"o_{s}.png" for s in suffixes]


def test_render3d_ssao_flags_change_the_image(tmp_path, scene_frep):
    base = ["render3d", scene_frep, "--size", "64", "--mode", "ssao",
            "--view", "identity"]
    cli.main(base + ["--out", str(tmp_path / "a.png")] + CPU)
    cli.main(base + ["--ssao-mode", "gather", "--ao-scale", "2", "--out",
                     str(tmp_path / "b.png")] + CPU)
    a = read_png_gray(str(tmp_path / "a_ssao.png"))
    b = read_png_gray(str(tmp_path / "b_ssao.png"))
    assert a.shape == b.shape == (64, 64) and not np.array_equal(a, b)
    assert ((a > 0) == (b > 0)).mean() > 0.98


# ---- the unrolled engine ----------------------------------------------------------

def test_render2d_unrolled_equals_the_jax_cli_and_the_interpreter(
        tmp_path, capsys):
    a, b, c = tmp_path / "u.png", tmp_path / "j.png", tmp_path / "i.png"
    args = ["render2d", "stress:12", "--size", "128"]
    cli.main(args + ["--engine", "unrolled", "--check", "--out", str(a)]
             + CPU)
    assert "oracle cross-check: mismatch 0.00e+00" in capsys.readouterr().out
    jcli.main(args + ["--engine", "unrolled", "--out", str(b)])
    cli.main(args + ["--out", str(c)] + CPU)
    assert a.read_bytes() == b.read_bytes() == c.read_bytes()


def test_render3d_unrolled_equals_the_interpreter(tmp_path, scene_frep):
    args = ["render3d", scene_frep, "--size", "128", "--mode", "all",
            "--view", "gui"]
    cli.main(args + ["--engine", "unrolled", "--out", str(tmp_path / "u.png")]
             + CPU)
    cli.main(args + ["--out", str(tmp_path / "i.png")] + CPU)
    assert (tmp_path / "u_depth.png").read_bytes() == \
        (tmp_path / "i_depth.png").read_bytes()
    for s in ("ssao", "shaded"):
        a = read_png_gray(str(tmp_path / f"u_{s}.png")).astype(int)
        b = read_png_gray(str(tmp_path / f"i_{s}.png")).astype(int)
        assert (np.abs(a - b) <= 1).mean() >= 0.99, s
    a, b = (_rgb(tmp_path / f"{x}_norm.png").astype(int) for x in "ui")
    assert (np.abs(a - b) <= 1).all(axis=-1).mean() >= 0.99


@pytest.mark.parametrize("engine", ["unrolled", "interp"])
def test_table2d_on_either_engine(capsys, one_frame, engine):
    """table2d (and table3d) default to the unrolled engine, as
    mpr_tpu.cli's do; --engine interp times the interpreter pipeline."""
    argv = ["table2d", "stress:12", "--sizes", "64,128"] + CPU
    cli.main(argv if engine == "unrolled" else argv + ["--engine", engine])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split() == ["size", "mean_ms"]
    assert [ln.split()[0] for ln in lines[1:]] == ["64", "128"]
    assert all(float(ln.split()[1]) > 0 for ln in lines[1:])


def test_table3d_on_the_interpreter(capsys, one_frame):
    cli.main(["table3d", "stress:12", "--sizes", "64", "--engine", "interp"]
             + CPU)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[1].split()[0] == "64" and float(lines[1].split()[1]) > 0


def test_table_effects_prints_three_columns(capsys):
    cli.main(["table-effects", "stress:12", "--sizes", "64,128", "--frames",
              "1"] + CPU)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split()[:4] == ["size", "depth+normals", "+ssao",
                                    "+shaded"]
    rows = [ln.split() for ln in lines[1:]]
    assert [r[0] for r in rows] == ["64", "128"]
    assert all(float(v) > 0 for r in rows for v in r[1:])


def test_unrolled_heatmaps_print_totals_and_write_images(tmp_path, capsys):
    import json
    a, b = tmp_path / "h2.png", tmp_path / "h3.png"
    cli.main(["heatmap2d", "stress:12", "--size", "128", "--engine",
              "unrolled", "--out", str(a)] + CPU)
    cli.main(["heatmap3d", "stress:12", "--size", "64", "--engine",
              "unrolled", "--out", str(b)] + CPU)
    t2, t3 = (json.loads(ln) for ln in
              capsys.readouterr().out.strip().splitlines())
    assert t2["clauses"] == t3["clauses"] > 0
    assert t2["attributable_evals"] == t2["executed_evals"] > 0
    assert set(t3["counts"]) == {"64^3", "16^3", "4^3"}
    for p, size in ((a, 128), (b, 64)):
        img = read_png_gray(str(p))
        assert img.shape == (size, size) and img.max() == 255


# ---- tables, brute, figures ---------------------------------------------------

def test_table2d_prints_a_row_per_size_and_profiles(tmp_path, capsys,
                                                    one_frame):
    cli.main(["table2d", "stress:12", "--sizes", "64,128", "--profile",
              str(tmp_path / "prof")] + CPU)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split() == ["size", "mean_ms"]
    assert [ln.split()[0] for ln in lines[1:]] == ["64", "128"]
    assert all(float(ln.split()[1]) > 0 for ln in lines[1:])
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 100


def test_table3d_prints_a_row_per_size(capsys, one_frame):
    cli.main(["table3d", "stress:12", "--sizes", "64"] + CPU)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split() == ["size", "mean_ms"]
    assert lines[1].split()[0] == "64" and float(lines[1].split()[1]) > 0


def test_table3d_stops_past_750_ms(capsys, monkeypatch):
    monkeypatch.setattr(timing, "time_frames",
                        lambda frame, *a, n=1, n0=1: 751.0)
    cli.main(["table3d", "stress:12", "--sizes", "64,128"] + CPU)
    cap = capsys.readouterr()
    assert len(cap.out.strip().splitlines()) == 2
    assert "stopped: mean > 750.0 ms" in cap.err


def test_brute_prints_agreement_and_two_rows(capsys, one_frame):
    """The agreement line and the timed rows: the tape as straight-line
    code (its plain torch version on the CPU), the brute interpreter and
    the full pipeline."""
    cli.main(["brute", "stress:12", "--size", "64"] + CPU)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "culling vs brute agreement: 1.000000"
    assert [ln.split(":")[0].strip() for ln in lines[1:]] == \
        ["unrolled-torch", "brute-interp", "full-pipeline"]
    assert all(ln.endswith("ms @ 64") for ln in lines[1:])


def test_shorten_stats_prints_the_jax_cli_lines(capsys):
    cli.main(["shorten-stats", "stress:12", "--size", "256"] + CPU)
    got = capsys.readouterr().out
    jcli.main(["shorten-stats", "stress:12", "--size", "256"])
    want = capsys.readouterr().out
    assert got == want and "shortened lengths (ambiguous tiles)" in got


def test_circle_figure_colors_the_stages(tmp_path):
    out = tmp_path / "c.png"
    cli.main(["circle-figure", "--size", "512", "--out", str(out)] + CPU)
    rgb = _rgb(out)
    colors = {tuple(c) for c in rgb.reshape(-1, 3)}
    assert colors == {(40, 40, 40), (60, 120, 220), (240, 160, 40),
                      (120, 80, 20)}


def test_heatmaps_write_grey_images(tmp_path):
    a, b = tmp_path / "h2.png", tmp_path / "h3.png"
    cli.main(["heatmap2d", "stress:12", "--size", "128", "--out", str(a)]
             + CPU)
    cli.main(["heatmap3d", "stress:12", "--size", "64", "--out", str(b)]
             + CPU)
    for p, size in ((a, 128), (b, 64)):
        img = read_png_gray(str(p))
        assert img.shape == (size, size) and img.max() == 255


# ---- tapes ---------------------------------------------------------------------

def test_dump_tape_prints_the_jax_cli_lines(capsys):
    for src in ("stress:12", TEXT_DEMO):
        cli.main(["dump-tape", src, "--limit", "25"])
        got = capsys.readouterr().out
        jcli.main(["dump-tape", src, "--limit", "25"])
        want = capsys.readouterr().out
        assert got == want and "length=" in got and "slots=" in got


def test_tape_time(capsys):
    cli.main(["tape-time", "stress:12"])
    assert "tape build:" in capsys.readouterr().out


def test_convert_writes_an_archive_both_packages_read(tmp_path):
    out = str(tmp_path / "s.frep")
    cli.main(["convert", "stress:12", out, "--name", "stress"])
    tape = mpr_tpu_torch.compile_tree(frep.load(out)[0].tree)
    jtape = jcompile_tree(jfrep.load(out)[0].tree)
    assert jfrep.load(out)[0].name == "stress"
    for f in ("ops", "outs", "lhss", "rhss", "imms"):
        assert np.array_equal(getattr(tape, f), getattr(jtape, f)), f
    want = mpr_tpu_torch.compile_tree(shapes.stress_2d(12))
    from mpr_tpu_torch import oracle
    rng = np.random.default_rng(3)
    x, y = (rng.uniform(-1, 1, 1000).astype(np.float32) for _ in range(2))
    assert np.array_equal(oracle.eval_f(tape, x, y),
                          oracle.eval_f(want, x, y))
    # a checkpoint converts too
    from mpr_tpu_torch.io import checkpoint
    npz = str(tmp_path / "t.npz")
    checkpoint.save_tape(npz, want)
    cli.main(["convert", npz, str(tmp_path / "c.frep")])
    back = mpr_tpu_torch.compile_tree(
        frep.load(str(tmp_path / "c.frep"))[0].tree)
    assert np.array_equal(oracle.eval_f(back, x, y),
                          oracle.eval_f(want, x, y))


# ---- devices and registration ---------------------------------------------------

RENDERING = [["render2d", "stress:12", "--size", "64"],
             ["render2d", "stress:12", "--size", "64", "--engine",
              "unrolled"],
             ["render3d", "stress:12", "--size", "64"],
             ["render3d", "stress:12", "--size", "64", "--engine",
              "unrolled"],
             ["table-effects", "stress:12", "--sizes", "64"],
             ["heatmap2d", "stress:12", "--size", "64", "--engine",
              "unrolled"],
             ["heatmap3d", "stress:12", "--size", "64", "--engine",
              "unrolled"],
             ["table2d", "stress:12", "--sizes", "64"],
             ["table3d", "stress:12", "--sizes", "64"],
             ["brute", "stress:12", "--size", "64"],
             ["shorten-stats", "stress:12", "--size", "64"],
             ["circle-figure", "--size", "64"],
             ["heatmap2d", "stress:12", "--size", "64"],
             ["heatmap3d", "stress:12", "--size", "64"],
             ["render2d", "stress:12", "--size", "64", "--sharded"],
             ["render3d", "stress:12", "--size", "64", "--sharded"],
             ["fit", "stress:12", "--target", "stress:13", "--size", "64",
              "--steps", "1"],
             ["fit", "stress:12", "--target", "stress:13", "--size", "16",
              "--steps", "1", "--mode", "3d"],
             ["mesh", "stress:12", "--size", "16"]]


@pytest.mark.parametrize("argv", RENDERING, ids=[
    a[0] + ("-unrolled" if "unrolled" in a else "")
    + ("-sharded" if "--sharded" in a else "")
    + ("-3d" if "--mode" in a else "") for a in RENDERING])
def test_without_a_card_the_default_device_raises(argv, tmp_path,
                                                  monkeypatch):
    """``--device`` defaults to cuda; with no card every rendering command
    fails rather than carrying on on the CPU, and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv + ["--device", "cuda"])
    assert not list(tmp_path.iterdir())


# None of these is a command of the port's command line: the viewer runs as
# its own module (python -m mpr_tpu_torch.viewer), the native tape compiler
# has no flag (compile_tree takes it under backend='auto'), and the port has
# no bench yet.
@pytest.mark.parametrize("argv", [["viewer", "examples/csg_demo.py"],
                                  ["viewer", "--serve", "8766"],
                                  ["bench"],
                                  ["tape-time", "stress:12", "--native"],
                                  ["dump-tape", "stress:12", "--native"]])
def test_what_is_not_ported_is_not_registered(argv, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 2
    capsys.readouterr()


def test_module_runs_as_a_script():
    import subprocess
    import sys
    root = str(pathlib.Path(__file__).resolve().parents[1])
    r = subprocess.run([sys.executable, "-m", "mpr_tpu_torch.cli",
                        "dump-tape", "stress:3", "--limit", "2"], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "length=" in r.stdout
