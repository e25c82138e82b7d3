"""The port's own copies of yolojax's jax-free modules, held against the
originals on the same inputs: ``config`` (load_config with overlays and
``-m`` mods, get_canvas, get_root_dir, get_cache_dir, get_model_dir,
get_eval_db, get_category_path, parse_attr on modules and names,
parse_attr_list, add_config_arguments, config_digest), ``category`` (get_category, get_anchors), ``cli``
(make_parser, setup) and ``utils.visualize`` (draw_boxes).  Each must give
exactly what the original gives.
"""

from pathlib import Path

import numpy as np
import pytest

import yolojax.category as jcategory
import yolojax.cli as jcli
import yolojax.config as jconfig
import yolojax.utils.visualize as jvisualize
import yolojax_torch.category as tcategory
import yolojax_torch.cli as tcli
import yolojax_torch.config as tconfig
import yolojax_torch.utils.visualize as tvisualize

ROOT = Path(__file__).resolve().parents[1]
OVERLAYS = {"root": [], "mobilenet": ["config/mobilenet.ini"], "tiny": ["config/tiny.ini"],
            "both": ["config/mobilenet.ini", "config/tiny.ini"]}
MODS = ["model/pallas=nms fusedpost dwsep dwconv", "data/sizes=320,320", "newsec/key=a=b"]


def _paths(overlay):
    return [str(ROOT / "config.ini"), *(str(ROOT / p) for p in OVERLAYS[overlay])]


def _items(config):
    return {s: dict(config.items(s)) for s in config.sections()}


@pytest.mark.parametrize("overlay", sorted(OVERLAYS))
def test_load_config_matches(overlay):
    want = jconfig.load_config(_paths(overlay), MODS[:2])
    got = tconfig.load_config(_paths(overlay), MODS[:2])
    assert _items(got) == _items(want)
    assert got.get("data", "sizes") == "320,320"


def test_parse_attr_list_resolves_to_the_port():
    config = jconfig.load_config(_paths("root"))
    names = config.get("transform", "train")
    got = tconfig.parse_attr_list(names)
    want = jconfig.parse_attr_list(names)
    assert [t.__name__ for t in got] == [t.__name__ for t in want] == [
        "RandomCrop", "RandomFlipHorizontally", "HSVJitter"]
    assert all(t.__module__ == "yolojax_torch.data.transform" for t in got)
    assert tconfig.parse_attr(config.get("train", "optimizer")).__module__ == \
        "yolojax_torch.utils.train"


@pytest.mark.parametrize("path", ["yolojax.data.voc", "yolojax.data.coco", "yolojax.eval_ap",
                                  " yolojax.data.cache "])
def test_parse_attr_resolves_a_module_path_to_the_port(path):
    got, want = tconfig.parse_attr(path), jconfig.parse_attr(path)
    assert got.__name__ == "yolojax_torch." + want.__name__[len("yolojax."):]
    assert hasattr(got, "load") or hasattr(got, "evaluate") or hasattr(got, "cache")


def test_parse_attr_raises_on_a_module_that_fails_to_import(tmp_path, monkeypatch):
    (tmp_path / "broken_dataset_module.py").write_text("import no_such_dependency_xyz\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    with pytest.raises(ModuleNotFoundError, match="no_such_dependency_xyz"):
        tconfig.parse_attr("broken_dataset_module")
    with pytest.raises(ModuleNotFoundError, match="no_such_dependency_xyz"):
        tconfig.parse_attr("broken_dataset_module.load")


def test_load_config_defaults_and_mods_match():
    assert tconfig.default_config_path() == jconfig.default_config_path()
    assert _items(tconfig.load_config()) == _items(jconfig.load_config())
    assert _items(tconfig.load_config(str(ROOT / "config.ini"), MODS)) == \
        _items(jconfig.load_config(str(ROOT / "config.ini"), MODS))
    for load in (jconfig.load_config, tconfig.load_config):
        with pytest.raises(ValueError, match="bad -m"):
            load(None, ["no-section-here"])


@pytest.mark.parametrize("overlay", sorted(OVERLAYS))
def test_paths_and_canvas_match(overlay, monkeypatch, tmp_path):
    monkeypatch.setenv("YJ_ROOT", str(tmp_path))
    for mods in ([], ["config/root=${YJ_ROOT}/r", "data/canvas=", "train/multi_scale_max=416"],
                 ["data/canvas=512", "model/name=other"]):
        want = jconfig.load_config(_paths(overlay), mods)
        got = tconfig.load_config(_paths(overlay), mods)
        assert tconfig.get_canvas(got) == jconfig.get_canvas(want)
        assert tconfig.get_model_dir(got) == jconfig.get_model_dir(want)
        assert tconfig.get_cache_dir(got) == jconfig.get_cache_dir(want)
        assert tconfig.get_category_path(got) == jconfig.get_category_path(want)
        assert tconfig.get_root_dir(got) == jconfig.get_root_dir(want)
        assert tconfig.get_eval_db(got) == jconfig.get_eval_db(want)


@pytest.mark.parametrize("overlay", ["root", "tiny", "mobilenet"])
def test_category_and_anchors_match(overlay):
    config = jconfig.load_config(_paths(overlay))
    assert tcategory.get_category(config) == jcategory.get_category(config)
    got, want = tcategory.get_anchors(config), jcategory.get_anchors(config)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    if overlay == "tiny":
        assert config.get("model", "anchors").endswith("tiny-voc.tsv")


def test_anchors_file_checks_match(tmp_path):
    bad = tmp_path / "bad.tsv"
    bad.write_text("1 2 3\n")
    for load in (jcategory.load_anchors_file, tcategory.load_anchors_file):
        with pytest.raises(ValueError, match="2 columns"):
            load(str(bad))


ARGV = ["-c", "config.ini", "config/tiny.ini", "-m", "model/pallas=nms", "data/sizes=64,64",
        "-m", "detect/threshold=0.3", "--logging", "debug"]


def test_make_parser_matches():
    want = jcli.make_parser("detect").parse_args(ARGV)
    got = tcli.make_parser("detect").parse_args(ARGV)
    assert vars(got) == vars(want)
    assert vars(tcli.make_parser("d").parse_args([])) == vars(jcli.make_parser("d").parse_args([]))


def test_setup_matches(monkeypatch):
    monkeypatch.chdir(ROOT)
    want = jcli.setup(jcli.make_parser("detect").parse_args(ARGV))
    got = tcli.setup(tcli.make_parser("detect").parse_args(ARGV))
    assert _items(got) == _items(want)
    assert got.get("detect", "threshold") == "0.3"


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_draw_boxes_matches(rng, dtype):
    image = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
    if dtype == "float32":
        image = image.astype(np.float32) / 255
    yx_min = rng.uniform(0, 0.5, (4, 2))
    yx_max = yx_min + rng.uniform(0.1, 0.5, (4, 2))
    cls = np.array([0, 3, 3, 19])
    conf = rng.uniform(0, 1, 4)
    category = jcategory.get_category(jconfig.load_config())
    for args in ((cls, conf, category), (cls, None, None), (cls[:0], None, category)):
        want = jvisualize.draw_boxes(image, yx_min, yx_max, *args)
        got = tvisualize.draw_boxes(image, yx_min, yx_max, *args)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert tvisualize.class_colors(7) == jvisualize.class_colors(7)


@pytest.mark.parametrize("sections", [("model",), ("model", "data", "transform"),
                                      ("cache", "nosuchsection"), ()])
@pytest.mark.parametrize("overlay", sorted(OVERLAYS))
def test_config_digest_matches(overlay, sections):
    config = tconfig.load_config(_paths(overlay), MODS)
    want = jconfig.config_digest(jconfig.load_config(_paths(overlay), MODS), sections)
    assert tconfig.config_digest(config, sections) == want
    assert len(want) == 12
