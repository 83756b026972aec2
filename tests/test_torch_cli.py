"""The port's CLI against the JAX package's on the CPU: argument parsing,
the default-mode fallback, config overrides, ``loop`` in both modes and
``reconstruct`` on the 32-frame fixture written as PNGs (console block and
``loop_closures.txt`` line for line; timing lines compared by their words),
and the ``calibrate`` entry point."""

import re

import numpy as np
import pytest
import torch

from slam_loop_closing_tpu import cli as jcli
from slam_loop_closing_tpu_torch import cli as tcli
from slam_loop_closing_tpu_torch.utils import synth_video

torch.set_num_threads(1)

import dataclasses

from slam_loop_closing_tpu import config as jconfig


@pytest.fixture(scope="module")
def config_json(tmp_path_factory):
    """test_loop_closing.py's small configuration (ORB-300, 2 levels, gap
    20, 128 RANSAC hypotheses) as a --config file both CLIs read."""
    cfg = dataclasses.replace(
        jconfig.PipelineConfig(),
        orb=jconfig.OrbConfig(num_features=300, num_levels=2),
        loop=jconfig.LoopConfig(loop_threshold=0.15, min_loop_gap=20,
                                frame_skip=1),
        ransac=jconfig.RansacConfig(num_hypotheses=128))
    path = tmp_path_factory.mktemp("cfg") / "small.json"
    path.write_text(cfg.to_json())
    return str(path)


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    """The 32-frame 144x192 orbit of test_loop_closing.py as frame_%04d.png."""
    frames = synth_video.orbit_sequence(num_frames=32, h=144, w=192,
                                        num_points=250, seed=3)
    return synth_video.write_frames(frames,
                                    tmp_path_factory.mktemp("cli") / "seq")


def _timeless(text: str) -> list[str]:
    """Console lines with every number after a colon-space in a timing line
    blanked (throughput and stage seconds vary by run)."""
    out = []
    for line in text.splitlines():
        if line.startswith("Throughput:") or re.match(r"  \w+: [\d.]+s$", line):
            line = re.sub(r"[\d.]+", "#", line)
        out.append(line)
    return out


class TestParser:
    def test_modes_parse(self):
        p = tcli._build_parser()
        for argv in (["extract", "--video", "x.MOV"],
                     ["loop", "--frames", "d"],
                     ["all", "--video", "x.MOV"],
                     ["reconstruct", "--frames", "d", "--scan"],
                     ["calibrate", "--images", "d"]):
            args = p.parse_args(argv)
            assert args.mode == argv[0]
        assert tcli.MODES == jcli.MODES

    def test_every_jax_flag_with_its_default(self):
        """Each mode takes the flags of the JAX CLI with the same defaults,
        plus --device (default cuda) where the mode computes."""
        for argv in (["extract", "--video", "x.MOV"], ["loop"], ["all"],
                     ["reconstruct"], ["calibrate"]):
            ref = vars(jcli._build_parser().parse_args(argv))
            got = vars(tcli._build_parser().parse_args(argv))
            if argv[0] != "extract":
                assert got.pop("device") == "cuda"
            assert got == ref
        args = tcli._build_parser().parse_args(
            ["loop", "--incremental", "--device", "cpu", "--resize", "0.5",
             "--trace", "t", "--output", "o", "--threshold", "0.2"])
        assert (args.batched, args.device, args.resize, args.trace,
                args.output, args.threshold) == (False, "cpu", 0.5, "t", "o",
                                                 0.2)

    def test_default_mode_is_loop(self):
        """README.md:62: bare invocation defaults to loop mode."""
        with pytest.raises(SystemExit) as e:
            tcli.main(["--frame-skip", "2"])
        assert "need --frames or --video" in str(e.value)
        with pytest.raises(SystemExit):
            tcli.main(["loop", "--frames", "/nonexistent/dir", "--device",
                       "cpu"])

    def test_config_overrides(self, tmp_path):
        p = tcli._build_parser()
        argv = ["loop", "--frames", "d", "--threshold", "0.7",
                "--min-gap", "10", "--num-features", "512"]
        cfg = tcli._load_config(p.parse_args(argv))
        assert cfg.loop.loop_threshold == 0.7
        assert cfg.loop.min_loop_gap == 10
        assert cfg.orb.num_features == 512
        ref = jcli._load_config(jcli._build_parser().parse_args(argv))
        assert cfg.to_json() == ref.to_json()
        (tmp_path / "c.json").write_text(ref.to_json())
        cfg2 = tcli._load_config(p.parse_args(
            ["loop", "--config", str(tmp_path / "c.json"), "--frame-skip",
             "2"]))
        assert cfg2.loop.frame_skip == 2 and cfg2.orb.num_features == 512


class TestLoopCli:
    @pytest.mark.parametrize("mode", ["--batched", "--incremental"])
    def test_loop_equals_jax(self, frames_dir, config_json, tmp_path, capsys,
                             monkeypatch, mode):
        # both CLIs read the PNGs with PIL: the native decoder scales by
        # 1/255 where PIL's path divides by 255, 1 ulp apart on a fifth of
        # the pixels, and the loop set moves; the JAX package's loader may
        # have latched a failed load in this process (ROADMAP F10), the
        # port's does not, so the two would not read alike
        from slam_loop_closing_tpu.utils import native as jnative
        from slam_loop_closing_tpu_torch.utils import native as tnative
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(tnative, "available", lambda: False)
        argv = ["loop", "--frames", str(frames_dir), mode, "--config",
                config_json, "--max-frames", "32"]
        assert jcli.main(argv + ["--output", str(tmp_path / "jax")]) == 0
        ref_out = capsys.readouterr().out
        assert tcli.main(argv + ["--output", str(tmp_path / "torch"),
                                 "--device", "cpu"]) == 0
        got_out = capsys.readouterr().out
        ref_txt = (tmp_path / "jax" / "loop_closures.txt").read_text()
        got_txt = (tmp_path / "torch" / "loop_closures.txt").read_text()
        assert "Frame 31 <-> Frame" in ref_txt
        assert got_txt.splitlines() == ref_txt.splitlines()
        assert _timeless(got_out.replace("/torch/", "/jax/")) == \
            _timeless(ref_out)
        assert "=== Processing Complete ===" in got_out
        assert "Total frames processed: 32" in got_out
        assert sorted(p.name for p in (tmp_path / "torch").iterdir()) == \
            sorted(p.name for p in (tmp_path / "jax").iterdir())

    def test_all_mode_resize_and_trace(self, frames_dir, tmp_path, capsys):
        """``all`` with --frames goes straight to the loop stage; --resize
        halves the frames; --trace writes a Chrome trace."""
        rc = tcli.main(["all", "--frames", str(frames_dir), "--resize", "0.5",
                        "--max-frames", "6", "--num-features", "100",
                        "--frame-skip", "2", "--min-gap", "2",
                        "--data-dir", str(tmp_path / "data"),
                        "--trace", str(tmp_path / "trace"),
                        "--device", "cpu"])
        out = capsys.readouterr().out
        assert rc == 0
        assert "Loaded 16 frames (72x96, frame_skip=2)" in out
        assert "Total frames processed: 6" in out
        assert (tmp_path / "data" / "loop_closing_results"
                / "loop_closures.txt").exists()
        assert (tmp_path / "trace" / "trace.json").stat().st_size > 0

    def test_module_entry_point(self, tmp_path):
        import subprocess
        import sys

        proc = subprocess.run(
            [sys.executable, "-m", "slam_loop_closing_tpu_torch.cli",
             "extract", "--help"], capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0 and "--video" in proc.stdout


class TestReconstructCli:
    def test_reconstruct_runs(self, tmp_path, capsys):
        frames = synth_video.orbit_sequence(num_frames=8, h=144, w=192,
                                            num_points=250, seed=5)
        d = synth_video.write_frames(frames, tmp_path / "seq")
        rc = tcli.main(["reconstruct", "--frames", str(d), "--frame-skip",
                        "1", "--num-features", "300", "--max-keyframes", "8",
                        "--data-dir", str(tmp_path / "data"), "--device",
                        "cpu"])
        out = capsys.readouterr().out
        assert rc == 0
        assert "Loaded 8 frames (144x192, frame_skip=1)" in out
        assert "frames/sec end-to-end" in out and "  reconstruct: " in out
        objs = list((tmp_path / "data" / "reconstruction").glob("*.obj"))
        assert len(objs) == 1 and f"OBJ: {objs[0]}" in out
        rc = tcli.main(["reconstruct", "--frames", str(d), "--frame-skip",
                        "1", "--num-features", "300", "--max-keyframes", "8",
                        "--no-obj", "--scan", "--data-dir",
                        str(tmp_path / "data2"), "--device", "cpu"])
        assert rc == 0 and "OBJ:" not in capsys.readouterr().out
        assert not (tmp_path / "data2" / "reconstruction").exists()


class TestCalibrateCli:
    def test_calibrate_runs(self, tmp_path, capsys):
        """test_cli.py's four boards through both CLIs: the same found
        lines, RMS within 1% of the JAX tool's, overlays written."""
        from slam_loop_closing_tpu_torch.utils.io import _write_png

        K = np.array([[300.0, 0, 160.0], [0, 300.0, 120.0], [0, 0, 1.0]])
        rng = np.random.default_rng(4)
        img_dir = tmp_path / "calib"
        img_dir.mkdir()
        for i in range(4):
            rv = rng.uniform(-0.2, 0.2, 3) * np.array([1, 1, 0.5])
            ang = max(np.linalg.norm(rv), 1e-9)
            axis = rv / ang
            Kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                           [-axis[1], axis[0], 0]])
            R = np.eye(3) + np.sin(ang) * Kx + (1 - np.cos(ang)) * Kx @ Kx
            center = np.array([9 * 0.03 / 2, 6 * 0.03 / 2, 0.0])
            C = center + R.T @ np.array([0, 0, -rng.uniform(0.6, 0.7)])
            img = synth_video.render_chessboard(K, R, -R @ C, 7, 10, 0.03,
                                                240, 320)
            _write_png(img_dir / f"board_{i}.png",
                       (img * 255).astype(np.uint8))

        assert jcli.main(["calibrate", "--images", str(img_dir)]) == 0
        ref = capsys.readouterr().out
        rc = tcli.main(["calibrate", "--images", str(img_dir), "--device",
                        "cpu", "--output-overlays", str(tmp_path / "overlays")])
        got = capsys.readouterr().out
        assert rc == 0
        assert (tmp_path / "overlays" / "corners_00.png").exists()
        assert (tmp_path / "overlays" / "corners_03.png").exists()
        assert got.splitlines()[:4] == ref.splitlines()[:4]
        rms = [float(re.search(r"error: ([\d.]+) px", t).group(1))
               for t in (got, ref)]
        assert rms[0] < 1.0 and abs(rms[0] - rms[1]) <= 0.01 * rms[1] + 1e-4
        with pytest.raises(SystemExit):
            tcli.main(["calibrate", "--images", str(tmp_path / "empty"),
                       "--device", "cpu"])
