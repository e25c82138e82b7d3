"""Shared by the port's deploy-tool and gate tests (not a test file): the
four model families of the repo's configs, built by both packages from one
config in f32, with one set of weights in the JAX package's layout drawn
from a numpy seed (He-normal HWIO convs, random BN statistics, γ and β) and
carried into the port by ``checkpoint.from_jax``; the reference's native
library loaded without its build race; torch on one thread for the gate
chains."""

import contextlib
import fcntl
import hashlib
import json
import os
import tempfile
from pathlib import Path

import numpy as np
import torch

import yolojax.cli.common as jcommon
from yolojax import native as jnative
from yolojax_torch.cli import common as tcommon
from yolojax_torch.config import load_config
from yolojax_torch.utils.checkpoint import from_jax

ROOT = Path(__file__).resolve().parents[1]
# (config files, mods): each family with the kernel tokens its path routes
FAMILIES = {
    "darknet": (["config.ini"], []),
    "darknet-s2d": (["config.ini"], ["model/reorg=s2d", "model/pallas=nms pool reorg"]),
    "tiny": (["config.ini", "config/tiny.ini"], ["model/pallas=nms fusedpost pool"]),
    "mobilenet": (["config.ini", "config/mobilenet.ini"],
                  ["model/pallas=nms fusedpost dwsep dwconv"]),
}


def reference_native_library() -> Path:
    """Where ``yolojax.native`` puts its library: ``~/.cache/yolojax``, named
    by the source's hash."""
    digest = hashlib.sha1((ROOT / "yolojax" / "native" / "nms.cpp").read_bytes()).hexdigest()
    return Path(os.path.expanduser("~/.cache/yolojax")) / f"nms_{digest[:12]}.so"


def load_reference_native():
    """Load ``yolojax.native``'s library in this process, or raise.

    The reference compiles into one shared ``<so>.tmp`` and remembers a
    failure for the process (``yolojax/native/__init__.py``), so test
    workers that build it at once can leave each other without it, or leave
    a broken ``.so`` behind.  Here the build runs under an ``fcntl`` lock
    beside ``~/.cache/yolojax``, a remembered failure is forgotten, and a
    library that will not load is deleted and built once more."""
    if jnative._LIB is not None:
        return jnative
    so = reference_native_library()
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.parent.parent / "yolojax.build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for _ in range(2):
            jnative._TRIED = False
            if jnative.native_nms_available():
                return jnative
            so.unlink(missing_ok=True)
            Path(f"{so}.tmp").unlink(missing_ok=True)
    raise RuntimeError(f"the reference's native NMS did not build or load ({so})")


@contextlib.contextmanager
def one_thread(mp):
    """Torch on one thread in this process and, through ``OMP_NUM_THREADS`` in
    ``mp``'s environment, in the processes it starts.  A gate chain runs
    beside the other test workers on the same cores; there, every thread
    more oversubscribes them and slows the chain instead of speeding it."""
    threads = torch.get_num_threads()
    mp.setenv("OMP_NUM_THREADS", "1")
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def family_config(name: str, *mods: str):
    files, base = FAMILIES[name]
    return load_config([str(ROOT / f) for f in files],
                       [*base, "model/dtype=float32", "data/sizes=64,64", *mods])


def narrow_config(name: str, *mods: str):
    """``family_config`` with every BN conv at an eighth of its width (at
    least 8 channels; depthwise convs follow their input), written to a
    ``[model] channels`` file: the same plan, for tests where the widths do
    not matter and the JAX package's compile time does."""
    _, _, model = tcommon.build(family_config(name))
    widths = {d.name: max(8, d.out_ch // 8) for d in model.layer_defs
              if d.bn and d.groups == 1}
    path = Path(tempfile.mkdtemp()) / f"{name}.json"
    path.write_text(json.dumps(widths))
    return family_config(name, f"model/channels={path}", *mods)


def numpy_weights(rng, model, gamma=(0.5, 1.5)):
    """JAX-layout numpy (params, state) for ``model``'s plan: HWIO He-normal
    convs, BN γ from U(gamma), β, running mean and variance random; the
    linear head a bias instead of BN."""
    params, state = {}, {}
    for d in model.layer_defs:
        fan_in = d.ksize * d.ksize * d.in_ch // d.groups
        w = rng.standard_normal((d.ksize, d.ksize, d.in_ch // d.groups, d.out_ch),
                                dtype=np.float32) * np.float32(np.sqrt(2.0 / fan_in))
        n = d.out_ch
        if not d.bn:
            params[d.name] = {"w": w, "b": rng.normal(0, 0.1, n).astype(np.float32)}
            continue
        params[d.name] = {"w": w, "gamma": rng.uniform(*gamma, n).astype(np.float32),
                          "beta": rng.normal(0, 0.1, n).astype(np.float32)}
        state[d.name] = {"mean": rng.normal(0, 0.2, n).astype(np.float32),
                         "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}
    return params, state


def both(config, rng, gamma=(0.5, 1.5)):
    """(JAX model, JAX numpy (params, state), port model, port (params,
    state)) on the same weights."""
    _, _, jmodel = jcommon.build(config)
    jparams, jstate = numpy_weights(rng, jmodel, gamma=gamma)
    _, _, model = tcommon.build(config)
    return jmodel, (jparams, jstate), model, from_jax(jparams, jstate)
