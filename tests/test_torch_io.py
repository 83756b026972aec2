"""The port's host-side IO against the JAX package's on the same inputs:
OBJ and loop-report text byte for byte, frame writing / enumeration /
loading, the extraction cache, the chessboard and orbit renderers, and the
match visualisation PNG."""

import numpy as np
import pytest

from slam_loop_closing_tpu.utils import io as jio
from slam_loop_closing_tpu.utils import synth_video as jsynth
from slam_loop_closing_tpu_torch.utils import io as tio
from slam_loop_closing_tpu_torch.utils import native as tnative
from slam_loop_closing_tpu_torch.utils import synth_video as tsynth


class TestObj:
    def test_vertex_layout_equals_jax(self, tmp_path):
        pts = np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
        R = np.stack([np.eye(3), np.eye(3)])
        t = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
        p = tio.write_obj(tmp_path / "x.obj", pts, R, t, log=lambda *a: None)
        ref = jio.write_obj(tmp_path / "ref.obj", pts, R, t,
                            log=lambda *a: None)
        assert p.read_text() == ref.read_text()
        lines = [ln for ln in p.read_text().splitlines()
                 if ln.startswith("v ")]
        assert len(lines) == 2 + 2 * 4
        assert [float(x) for x in lines[2 + 4].split()[1:]] == [-1.0, 0.0, 0.0]

    def test_masks_drop_entries(self, tmp_path):
        kw = dict(point_valid=np.array([1, 0, 1, 0, 0], bool),
                  cam_valid=np.array([1, 1, 0], bool), log=lambda *a: None)
        args = (np.zeros((5, 3)), np.stack([np.eye(3)] * 3), np.zeros((3, 3)))
        p = tio.write_obj(tmp_path / "m.obj", *args, **kw)
        ref = jio.write_obj(tmp_path / "r.obj", *args, **kw)
        assert p.read_text() == ref.read_text()
        assert tio.reconstruction_obj_path(tmp_path).parent == \
            jio.reconstruction_obj_path(tmp_path).parent


class TestLoopTxt:
    LOOPS = [{"current": 93, "matched": 0, "num_matches": 434,
              "similarity": 0.2085},
             {"current": 96, "matched": 0, "num_matches": 236,
              "similarity": 0.217000}]

    def test_report_equals_jax(self, tmp_path):
        p = tio.write_loop_closures_txt(tmp_path / "loop_closures.txt",
                                        self.LOOPS, total_frames=97)
        assert p.read_text() == jio.format_loop_closures(self.LOOPS, 97)
        assert "  Similarity: 0.217\n" in p.read_text()
        assert tio.format_loop_closures([]) == jio.format_loop_closures([])


class TestFrames:
    def test_write_enumerate_load_equal_jax(self, tmp_path, monkeypatch):
        # the PIL path (the native decoder's own file holds it to PIL and
        # to the JAX package's decoder)
        monkeypatch.setattr(tnative, "available", lambda: False)
        frames = tsynth.orbit_sequence(num_frames=5, h=32, w=48, num_points=30)
        d = tsynth.write_frames(frames, tmp_path / "seq")
        ref_dir = jsynth.write_frames(frames, tmp_path / "ref")
        paths = tio.enumerate_frames(d)
        assert [p.name for p in paths] == [
            p.name for p in jio.enumerate_frames(ref_dir)]
        assert len(paths) == 5 and paths[0].name == "frame_0000.png"
        for a, b in zip(paths, jio.enumerate_frames(ref_dir)):
            assert a.read_bytes() == b.read_bytes()
        loaded = tio.load_frames_gray(paths, frame_skip=2)
        assert loaded.shape == (3, 32, 48) and loaded.dtype == np.float32
        np.testing.assert_array_equal(
            loaded, np.stack([jio.load_frame_gray(p) for p in paths[::2]]))
        np.testing.assert_allclose(loaded[0], frames[0], atol=0.01)

    def test_resize_and_rgb_to_gray_equal_jax(self, tmp_path):
        rgb = np.random.default_rng(1).integers(
            0, 256, (20, 30, 3)).astype(np.uint8)
        tio._write_png(tmp_path / "c.png", rgb)
        got = tio.load_frame_gray(tmp_path / "c.png", resize_hw=(10, 15))
        ref = jio.load_frame_gray(tmp_path / "c.png", resize_hw=(10, 15))
        assert got.shape == (10, 15)
        np.testing.assert_array_equal(got, ref)

    def test_enumeration_stops_at_first_gap(self, tmp_path):
        frames = np.zeros((4, 8, 8), np.float32)
        d = tsynth.write_frames(frames, tmp_path / "seq")
        (d / "frame_0002.png").unlink()
        assert len(tio.enumerate_frames(d)) == 2
        assert tio.enumerate_frames(tmp_path / "none") == []

    def test_extraction_cache_skip(self, tmp_path):
        out = tmp_path / "data" / "extracted_frames" / "vid"
        out.mkdir(parents=True)
        msgs, ref_msgs = [], []
        res = tio.extract_images(str(tmp_path / "vid.MOV"),
                                 str(tmp_path / "data"), log=msgs.append)
        jio.extract_images(str(tmp_path / "vid.MOV"), str(tmp_path / "data"),
                           log=ref_msgs.append)
        assert res == out and msgs == ref_msgs
        assert any("Skipping" in m for m in msgs)

    def test_extract_images_from_frame_iterator(self, tmp_path, monkeypatch):
        """extract_images with the decoder replaced by three RGB frames: the
        reference's file names and log lines, as the JAX package's."""
        rgb = np.random.default_rng(2).integers(
            0, 256, (3, 12, 16, 3)).astype(np.uint8)
        logs = {}
        for name, mod in (("torch", tio), ("jax", jio)):
            monkeypatch.setattr(mod, "_iter_video_frames",
                                lambda path: iter(rgb))
            monkeypatch.setattr(mod, "_video_metadata",
                                lambda path: (30.0, 3))
            logs[name] = []
            out = mod.extract_images("clip.MOV", str(tmp_path / name),
                                     log=logs[name].append)
            assert [p.name for p in sorted(out.iterdir())] == [
                "frame_0000.png", "frame_0001.png", "frame_0002.png"]
        assert [m.replace("/torch/", "/jax/") for m in logs["torch"]] == \
            logs["jax"]
        assert logs["torch"][1] == "FPS: 30, Total Frames: 3"
        assert (tmp_path / "torch/extracted_frames/clip/frame_0001.png"
                ).read_bytes() == (
            tmp_path / "jax/extracted_frames/clip/frame_0001.png").read_bytes()

    def test_video_decoders_fail_cleanly(self, tmp_path):
        assert tio._video_metadata(str(tmp_path / "missing.MOV")) == (0.0, 0)
        with pytest.raises(RuntimeError):
            list(tio._iter_video_frames(str(tmp_path / "missing.MOV")))


class TestMatchViz:
    def test_png_equals_jax(self, tmp_path):
        from PIL import Image

        img = np.random.default_rng(0).random((40, 60)).astype(np.float32)
        xy = np.array([[10.0, 10.0], [20.0, 20.0]])
        args = (img, (img[:30] * 255).astype(np.uint8), xy, xy,
                np.array([True, False]), np.array([0, 1]))
        p = tio.save_match_visualization(tmp_path / "m.png", *args)
        ref = jio.save_match_visualization(tmp_path / "r.png", *args)
        got = np.asarray(Image.open(p))
        assert got.shape == (40, 120, 3)
        np.testing.assert_array_equal(got, np.asarray(Image.open(ref)))
        assert (got[10, 10:70, 1] == 255).any()        # the match line


def test_chessboard_renderer_views():
    """The calibration scene: six views, board squares at 0 and 1 on a gray
    background, deterministic from the seed."""
    K, images = tsynth.chessboard_views()
    assert len(images) == 6 and images[0].shape == (240, 320)
    assert K[0, 0] == 300.0 and K[0, 2] == 160.0 and K[1, 2] == 120.0
    assert images[0].dtype == np.float32
    assert images[0].min() == 0.0 and images[0].max() == 1.0
    assert images[0][0, 0] == 0.5
    np.testing.assert_array_equal(tsynth.chessboard_views()[1][3], images[3])
