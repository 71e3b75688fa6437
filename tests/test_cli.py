"""CLI smoke tests + BPr runner."""
import json

from polardecoding_tpu.cli import main
from polardecoding_tpu.configs import preset
from polardecoding_tpu.parallel.harness import run_bpr_point


def test_cli_presets(capsys):
    main(["presets"])
    out = capsys.readouterr().out
    assert "BP_128" in out and "CASCL_1024_sys_L8" in out


def test_cli_run_and_plot(tmp_path, capsys):
    out_json = str(tmp_path / "r.json")
    main([
        "run", "--preset", "SC_128", "--snr", "2.0", "--batch", "64",
        "--error-blocks", "3", "--max-frames", "128", "--out", out_json,
    ])
    recs = json.loads(open(out_json).read())
    assert recs[0]["snr_db"] == 2.0 and recs[0]["frames"] >= 64
    png = str(tmp_path / "c.png")
    main(["plot", out_json, "--out", png])
    assert "wrote" in capsys.readouterr().out


def test_cli_analyze(capsys):
    main(["analyze", "--tool", "bpdega", "--N", "128", "--K", "64",
          "--snr", "3.0", "--iters", "100"])
    out = json.loads(capsys.readouterr().out)
    assert abs(out["3.0"]["bler"] - 0.072019) < 1e-4  # golden BPDEGA value


def test_bpr_runner():
    p = preset("BPr_128")
    res, E = run_bpr_point(p, 2.0, batch=64, error_blocks=2, max_frames=128)
    n = p.code.N.bit_length() - 1
    assert E.shape == (len(p.decoder.bpr_checkpoints), n + 1)
    # late checkpoints never have more info-bit errors than frames * K
    assert (E <= res.frames * p.code.K).all()
    assert res.frames >= 64


def test_cli_bench_smoke(capsys):
    """`cli bench` is a measurement, so with no GPU it refuses instead of
    timing the CPU; the bench.py API it is wired to (bench_step, renamed
    once and silently broken then) still runs here."""
    import importlib.util
    import os

    import pytest

    with pytest.raises(SystemExit, match="no GPU"):
        main(["bench", "--preset", "SC_128", "--batch", "64"])
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "bench.py")
    spec = importlib.util.spec_from_file_location("bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fps, compile_s = mod.bench_step("SC_128", 64, steps=1)
    assert fps > 0 and compile_s > 0
