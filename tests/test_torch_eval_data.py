"""The data side of eval in the port against ``yolojax``: the synthetic
workspace writer, the cache builder with its VOC and COCO parsers, the cache
and estimate CLIs, and the anchor k-means.

Workspaces come from ``yolojax.data.synth`` (8 images each, seeded); the
port's writer must write the same files byte for byte.  The two packages'
builders write to separate roots and must give identical records (same
paths, exactly equal arrays and dtypes).
"""

import filecmp
import pickle
from pathlib import Path

import numpy as np
import pytest

import yolojax.cli.cache as jcli_cache
import yolojax.cli.estimate as jcli_estimate
import yolojax.config as jconfig
import yolojax.data.cache as jcache
import yolojax.data.synth as jsynth
import yolojax.tools.kmeans as jkmeans
import yolojax_torch.cli.cache as tcli_cache
import yolojax_torch.cli.estimate as tcli_estimate
import yolojax_torch.config as tconfig
import yolojax_torch.data.cache as tcache
import yolojax_torch.data.coco as tcoco
import yolojax_torch.data.synth as tsynth
import yolojax_torch.data.voc as tvoc
import yolojax_torch.tools.kmeans as tkmeans

ROOT = Path(__file__).resolve().parents[1]
IMAGES = 8


def _overlay(root: Path, kind: str, data: Path, artifacts: str) -> Path:
    (root / "cat8").write_text("\n".join(jsynth.CLASSES))
    datasets = {"voc": f"yolojax.data.voc\nvoc_roots = {data}",
                "coco": f"yolojax.data.coco\ncoco_root = {data}"}[kind]
    path = root / f"{kind}_{artifacts}.ini"
    path.write_text(f"[config]\nroot = {root}/{artifacts}\n[cache]\ncategory = {root}/cat8\n"
                    f"datasets = {datasets}\n")
    return path


@pytest.fixture(scope="module")
def workspaces(tmp_path_factory):
    """{kind: (root, data dir written by yolojax, data dir written by the port)}."""
    out = {}
    for kind in ("voc", "coco"):
        root = tmp_path_factory.mktemp(kind)
        if kind == "voc":
            dirs = [jsynth.generate_voc(str(root / "jax"), IMAGES, seed=5),
                    tsynth.generate_voc(str(root / "port"), IMAGES, seed=5)]
        else:
            dirs = [pkg.generate_coco(str(root / name), IMAGES, seed=6, num_classes=8,
                                      crowd_frac=0.3)
                    for pkg, name in ((jsynth, "jax"), (tsynth, "port"))]
        out[kind] = (root, *map(Path, dirs))
    return out


def _files(d: Path):
    return sorted(p.relative_to(d) for p in d.rglob("*") if p.is_file())


@pytest.mark.parametrize("kind", ["voc", "coco"])
def test_synth_writes_what_the_reference_writes(workspaces, kind):
    _, jdir, tdir = workspaces[kind]
    files = _files(jdir)
    assert files == _files(tdir) and len(files) >= IMAGES
    _, mismatch, errors = filecmp.cmpfiles(jdir, tdir, [str(f) for f in files], shallow=False)
    assert not mismatch and not errors
    assert tsynth.make_classes(20) == jsynth.make_classes(20)


def _same_records(got: dict, want: dict):
    assert got.keys() == want.keys()
    for phase in want:
        assert len(got[phase]) == len(want[phase])
        for g, w in zip(got[phase], want[phase]):
            assert g.keys() == w.keys() and g["path"] == w["path"]
            for k in ("yx_min", "yx_max", "cls", "difficult"):
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), (phase, k)


@pytest.mark.parametrize("kind", ["voc", "coco"])
def test_cache_builders_give_identical_records(workspaces, kind):
    root, jdir, _ = workspaces[kind]
    jcfg = jconfig.load_config([str(ROOT / "config.ini"), str(_overlay(root, kind, jdir, "j"))])
    tcfg = tconfig.load_config([str(ROOT / "config.ini"), str(_overlay(root, kind, jdir, "t"))])
    want = jcache.cache(jcfg)
    got = tcache.cache(tcfg)
    _same_records(got, want)
    assert sum(len(r) for r in got.values()) >= IMAGES
    if kind == "coco":   # iscrowd is the difficult flag
        assert any(r["difficult"].any() for r in got["train"] + got["test"])
    # the pickles on disk: the port reads the reference's and the other way
    for phase in want:
        with open(jcache.cache_path(jcfg, phase), "rb") as f:
            jrec = pickle.load(f)
        _same_records({phase: tcache.load_cache(tcfg, phase)}, {phase: jrec})
        _same_records({phase: jcache.load_cache(tcfg, phase)}, {phase: jrec})


def test_parsers_match_on_one_file(workspaces):
    from yolojax.data import coco as jcoco
    from yolojax.data import voc as jvoc

    _, vdir, _ = workspaces["voc"]
    names = {n: i for i, n in enumerate(jsynth.CLASSES)}
    xml = sorted((vdir / "Annotations").iterdir())[0]
    got = tvoc.parse_annotation(str(xml), "img.jpg", names)
    want = jvoc.parse_annotation(str(xml), "img.jpg", names)
    _same_records({"x": [got]}, {"x": [want]})
    assert tvoc.parse_annotation(str(xml), "img.jpg", {}) is None
    _, cdir, _ = workspaces["coco"]
    path = str(cdir / "annotations" / "instances_val2017.json")
    _same_records({"x": tcoco.parse_instances(path, "r", jsynth.CLASSES[:5])},
                  {"x": jcoco.parse_instances(path, "r", jsynth.CLASSES[:5])})


def test_cache_and_estimate_clis_match(workspaces, capsys):
    root, jdir, _ = workspaces["voc"]
    argv = lambda tag: ["-c", str(ROOT / "config.ini"), str(_overlay(root, "voc", jdir, tag))]
    assert jcli_cache.main(argv("jc") + ["-p", "train", "test"]) == 0
    assert tcli_cache.main(argv("tc") + ["-p", "train", "test"]) == 0
    for phase in ("train", "test"):
        assert filecmp.cmp(root / "jc/cache/cat8" / f"{phase}.pkl",
                           root / "tc/cache/cat8" / f"{phase}.pkl", shallow=False)
    assert not (root / "tc/cache/cat8/val.pkl").exists()
    capsys.readouterr()
    outs = []
    for main, tag in ((jcli_estimate.main, "jc"), (tcli_estimate.main, "tc")):
        tsv = root / f"{tag}.tsv"
        assert main(argv(tag) + ["-k", "3", "--size", "64", "--seed", "2", "-o", str(tsv)]) == 0
        outs.append((capsys.readouterr().out, tsv.read_text()))
    assert outs[0] == outs[1] and len(outs[0][1].splitlines()) == 3


@pytest.mark.parametrize("k,seed", [(2, 0), (5, 1), (9, 3)])
def test_kmeans_gives_the_reference_anchors(workspaces, k, seed):
    root, jdir, _ = workspaces["voc"]
    cfg = jconfig.load_config([str(ROOT / "config.ini"), str(_overlay(root, "voc", jdir, "k"))])
    records = tcache.cache(cfg, phases=("train",))["train"]
    hw = tkmeans.collect_hw(records, grid=13.0)
    assert np.array_equal(hw, jkmeans.collect_hw(records, grid=13.0))
    got, got_iou = tkmeans.kmeans_anchors(hw, k, iters=50, seed=seed)
    want, want_iou = jkmeans.kmeans_anchors(hw, k, iters=50, seed=seed)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    assert got_iou == want_iou and 0 < got_iou <= 1


def test_config_resolves_the_dataset_modules_to_the_port():
    assert tconfig.parse_attr("yolojax.data.voc") is tvoc
    assert tconfig.parse_attr("yolojax.data.coco") is tcoco
    assert tconfig.parse_attr_list(tconfig.load_config().get("cache", "datasets")) == [tvoc]
