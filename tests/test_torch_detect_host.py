"""Port parity, the host detect path: ``Inference.detect_fn_host`` (forward
and decode on the model's device, the native C++ NMS on the host),
``cli/detect.py::detect_image`` and the detect CLI's video, camera and
``--show`` paths, against ``yolojax`` on the CPU in f32 at 64² with the
same weights (``checkpoint.from_jax``).

Tolerances: ``keep`` exact; against the JAX host path conf atol 1e-5, as
``tests/test_models.py`` holds the JAX host path to its device path, and
corners atol 1e-5 plus rtol 1e-4: a random head's corners reach |20|
(``exp(t_hw)`` of raw values near 3), where the raw heads' ~1e-5 relative
difference (23 convolutions summed in another order) is 1e-4 absolute and
more; against the
port's own ``detect_fn`` on the same raw head, conf and corners identical;
``detect_image`` and the CLI's detections as ``tests/test_torch_inference.py``
holds ``detect_image`` (classes exact, conf rtol 1e-4, boxes atol 1e-4).
"""

import shutil

import numpy as np
import pytest
import torch

import yolojax.cli.common as jcommon
import yolojax.cli.detect as jdetect
from yolojax.models.inference import Inference as JInference
from yolojax.utils import checkpoint as jckpt
from yolojax_torch import native
from yolojax_torch.cli import detect as tdetect
from yolojax_torch.config import load_config
from yolojax_torch.models.inference import Inference
from yolojax_torch.utils import checkpoint as tckpt

from torch_port_families import ROOT, both, load_reference_native, narrow_config, numpy_weights

THRESHOLD, OVERLAP, TOPK = 0.01, 0.45, 7


@pytest.fixture(autouse=True)
def toolchain():
    """Both libraries loaded; a skip only where there is no g++ at all: with g++
    present a failed build fails the test."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    assert native.native_nms_available(), native._error
    load_reference_native()


def masked(out, keep):
    keep = np.asarray(keep)
    return (np.where(keep, np.asarray(out.conf), 0),
            np.where(keep[..., None], np.asarray(out.yx_min), 0),
            np.where(keep[..., None], np.asarray(out.yx_max), 0))


@pytest.mark.parametrize("family", ["tiny", "darknet", "mobilenet", "darknet-s2d"])
def test_detect_fn_host_matches_jax(rng, family):
    jmodel, (jp, js), model, (p, s) = both(narrow_config(family), rng)
    images = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jinf = JInference(jmodel)
    want = jinf.detect_fn_host(THRESHOLD, OVERLAP, TOPK)(jinf.fold(jp, js), images)
    inf = Inference(model)
    got = inf.detect_fn_host(THRESHOLD, OVERLAP, TOPK)(inf.fold(p, s), torch.from_numpy(images))
    assert got.conf.shape == (2, model.num_classes, TOPK) and got.keep.dtype == torch.bool
    assert all(t.device.type == "cpu" for t in got)
    np.testing.assert_array_equal(got.keep.numpy(), np.asarray(want.keep))
    assert want.keep.any()
    (gc, *gboxes), (wc, *wboxes) = masked(got, want.keep), masked(want, want.keep)
    np.testing.assert_allclose(gc, wc, atol=1e-5)
    for g, w in zip(gboxes, wboxes):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("family", ["tiny", "darknet"])
@pytest.mark.parametrize("threshold", [0.005, 0.05])
def test_detect_fn_host_matches_detect_fn(rng, family, threshold):
    _, _, model, (p, s) = both(narrow_config(family), rng)
    inf = Inference(model)
    folded = inf.fold(p, s)
    images = torch.from_numpy(rng.uniform(0, 1, (3, 64, 64, 3)).astype(np.float32))
    got = inf.detect_fn_host(threshold, OVERLAP, 100)(folded, images)
    want = inf.detect_fn(threshold, OVERLAP, 100)(folded, images)
    np.testing.assert_array_equal(got.keep.numpy(), want.keep.numpy())
    assert want.keep.any()
    for g, w in zip(masked(got, want.keep), masked(want, want.keep)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("family", ["tiny", "darknet"])
def test_detect_image_takes_the_host_path_and_matches_jax(rng, family, caplog):
    config = narrow_config(family, "data/canvas=96", "detect/threshold=0.02")
    jmodel, (jp, js), model, (p, s) = both(config, rng)
    image = rng.integers(0, 255, (60, 80, 3), dtype=np.uint8)
    want = jdetect.detect_image(config, jmodel, jp, js, image, 64)
    with caplog.at_level("INFO", logger="yolojax_torch.cli.detect"):
        got = tdetect.detect_image(config, model, p, s, image, 64)
    assert "native NMS (detect_fn_host)" in caplog.text
    assert len(want[2]) > 0
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[3], want[3], rtol=1e-4)
    np.testing.assert_allclose(got[0], want[0], atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], atol=1e-4)


def test_detect_image_without_the_library_takes_detect_fn(rng, monkeypatch, caplog):
    config = narrow_config("tiny", "data/canvas=96", "detect/threshold=0.02")
    _, _, model, (p, s) = both(config, rng)
    image = rng.integers(0, 255, (60, 80, 3), dtype=np.uint8)
    want = tdetect.detect_image(config, model, p, s, image, 64)
    monkeypatch.setattr(tdetect, "native_nms_available", lambda: False)
    with caplog.at_level("INFO", logger="yolojax_torch.cli.detect"):
        got = tdetect.detect_image(config, model, p, s, image, 64)
    assert "detect_fn on cpu" in caplog.text
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -- the CLI's frame loops -------------------------------------------------------

@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Three 96×128 frames, a config overlay (Tiny, f32, 64²) and one JAX
    checkpoint both CLIs load with -f."""
    import cv2

    root = tmp_path_factory.mktemp("ws")
    rng = np.random.default_rng(3)
    frames = []
    for i in range(3):
        img = np.full((96, 128, 3), 40, np.uint8)
        y0, x0 = int(rng.integers(8, 56)), int(rng.integers(8, 88))
        img[y0:y0 + 32, x0:x0 + 32] = (255, 64, 64) if i % 2 else (64, 255, 64)
        frames.append(img)
    anchors = root / "anchors.tsv"
    anchors.write_text("1.0\t1.0\n2.5\t2.5\n")
    overlay = root / "ws.ini"
    overlay.write_text(f"[config]\nroot = {root}/artifacts\n[model]\nname = cam\n"
                       f"dnn = yolojax.models.darknet.Tiny\nanchors = {anchors}\n"
                       "dtype = float32\n[data]\ncanvas = 160\nsizes = 64,64\n"
                       "[detect]\nthreshold = 0.02\ntopk = 5\n")
    cfg = ["-c", str(ROOT / "config.ini"), str(overlay)]
    _, _, jmodel = jcommon.build(load_config(cfg[1:]))
    params, state = numpy_weights(np.random.default_rng(4), jmodel)
    ckpt = root / "1.npz"
    jckpt.save(str(ckpt), {"params": params, "state": state}, {"step": 1})
    clip = root / "clip.avi"
    writer = cv2.VideoWriter(str(clip), cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (128, 96))
    for f in frames:
        writer.write(f[:, :, ::-1])
    writer.release()
    return root, cfg + ["-f", str(ckpt), "--size", "64"], frames, clip


def record(monkeypatch, module):
    """Wrap ``module.detect_image`` to keep each frame's input and detections."""
    seen, real = [], module.detect_image

    def spy(config, model, params, state, image, size):
        out = real(config, model, params, state, image, size)
        seen.append((image.copy(), out))
        return out

    monkeypatch.setattr(module, "detect_image", spy)
    return seen


def count_frames(path) -> int:
    import cv2

    cap, n = cv2.VideoCapture(str(path)), 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def same_detections(got, want):
    assert len(got) == len(want) and len(got) > 0
    assert sum(len(w[2]) for w in want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[2], w[2])
        np.testing.assert_allclose(g[3], w[3], rtol=1e-4)
        np.testing.assert_allclose(g[0], w[0], atol=1e-4)
        np.testing.assert_allclose(g[1], w[1], atol=1e-4)


@pytest.fixture(scope="module")
def reference(workspace):
    """The JAX package's detect_image, with the checkpoint both CLIs load, on
    the workspace's frames and on the clip's frames as cv2 decodes them."""
    import cv2

    root, cfg, frames, clip = workspace
    config = load_config(cfg[1:cfg.index("-f")])
    _, _, jmodel = jcommon.build(config)
    trees, _ = tckpt.load(cfg[cfg.index("-f") + 1])     # the JAX layout, as numpy
    cap, decoded = cv2.VideoCapture(str(clip)), []
    while (item := cap.read())[0]:
        decoded.append(item[1][:, :, ::-1])
    cap.release()
    detect = lambda f: jdetect.detect_image(config, jmodel, trees["params"], trees["state"],
                                            f, 64)
    return [detect(f) for f in frames], [detect(f) for f in decoded]


def test_detect_cli_camera_matches_jax(workspace, reference, monkeypatch):
    """An integer input opens that camera; ``cv2.VideoCapture`` is faked to
    serve the frames, as ``tests/test_cli_end_to_end.py`` fakes it.  Each
    frame's detections are the JAX package's ``detect_image``'s."""
    import cv2

    root, cfg, frames, _ = workspace
    opened = []

    class FakeCamera:
        def __init__(self, index):
            assert index == 0
            self._n = 0
            opened.append(self)

        def read(self):
            if self._n >= len(frames):
                return False, None
            self._n += 1
            return True, frames[self._n - 1][:, :, ::-1].copy()

        def get(self, prop):
            return 10.0 if prop == cv2.CAP_PROP_FPS else 0.0

        def release(self):
            self.released = True

    real_capture = cv2.VideoCapture
    monkeypatch.setattr(cv2, "VideoCapture",
                        lambda arg: FakeCamera(arg) if isinstance(arg, int) else real_capture(arg))
    got = record(monkeypatch, tdetect)
    out = root / "cam.avi"
    assert tdetect.main(cfg + ["--device", "cpu", "-o", str(out), "0"]) == 0
    assert opened and opened[0].released
    assert count_frames(out) == 3
    same_detections([d for _, d in got], reference[0])


def test_detect_cli_video_matches_jax(workspace, reference, monkeypatch):
    """A video file runs the same frame loop and writes one annotated video
    of as many frames; each decoded frame's detections are the JAX
    package's."""
    root, cfg, _, clip = workspace
    got = record(monkeypatch, tdetect)
    out = root / "port.avi"
    assert tdetect.main(cfg + ["--device", "cpu", "-o", str(out), str(clip)]) == 0
    assert count_frames(out) == 3
    same_detections([d for _, d in got], reference[1])


def test_detect_cli_show_and_image(workspace, reference, monkeypatch):
    import cv2
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    root, cfg, frames, _ = workspace
    shown = []
    monkeypatch.setattr(plt, "show", lambda: shown.append(1))
    img = root / "frame.png"
    cv2.imwrite(str(img), frames[0][:, :, ::-1])
    got = record(monkeypatch, tdetect)
    out = root / "det.png"
    assert tdetect.main(cfg + ["--device", "cpu", "--show", "-o", str(out), str(img)]) == 0
    assert shown == [1] and cv2.imread(str(out)).shape == (96, 128, 3)
    same_detections([d for _, d in got], reference[0][:1])


def test_detect_cli_unreadable_input_exits(workspace, tmp_path):
    _, cfg, _, _ = workspace
    bad = tmp_path / "not_media.txt"
    bad.write_text("no frames here")
    with pytest.raises(SystemExit, match="cannot read"):
        tdetect.main(cfg + ["--device", "cpu", str(bad)])
