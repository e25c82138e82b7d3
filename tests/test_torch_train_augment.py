"""Port parity, train augmentation: ``yolojax_torch.data.transform.TrainAugment``
against ``yolojax.data.transform.TrainAugment`` on the same canvases, with
the JAX package's random draws injected into the port's ``apply``.

The draws are computed here from the JAX key exactly as the JAX package's
``_one`` takes them (``split(key, B)``, then ``split(k, 5)`` per image: crop
pads, flip, hue, saturation, exposure).  Crop, flip and HSV are checked each
alone and all together.  Tolerances: f32 pixels atol 5e-5 (the hue of a
pixel of small chroma divides the resize's rounding by the chroma; measured
1.5e-5 with crop and HSV together, 1e-6 for each alone); bf16 pixels
within 2 bf16 ulps of 1 (2⁻⁶: the resize rounds after each of its two
contractions, in an order of the library's choosing) with 99.9 % of them
within 1 ulp; boxes atol 1e-6 and ``valid`` identical in both.  Also the
colour-space helpers and ``from_config``.
"""

import configparser

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolojax.data import transform as jtransform
from yolojax_torch.data import transform

OPS = {"crop": dict(crop=True, flip=False, hsv=False),
       "flip": dict(crop=False, flip=True, hsv=False),
       "hsv": dict(crop=False, flip=False, hsv=True),
       "all": dict(crop=True, flip=True, hsv=True)}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def jax_draws(aug, key, batch):
    """The per-image draws of ``yolojax.data.transform.TrainAugment._one``."""
    pads, flip, dh, ds, dv = [], [], [], [], []
    for k in jax.random.split(key, batch):
        k_crop, k_flip, k_hue, k_sat, k_val = jax.random.split(k, 5)
        pads.append(jax.random.uniform(k_crop, (4,), minval=-aug.jitter, maxval=aug.jitter))
        flip.append(jax.random.bernoulli(k_flip, aug.flip_prob))
        dh.append(jax.random.uniform(k_hue, (), minval=-aug.hue, maxval=aug.hue))
        ds.append(jtransform._rand_scale(k_sat, aug.saturation))
        dv.append(jtransform._rand_scale(k_val, aug.exposure))
    out = {"pads": pads, "flip": flip, "dh": dh, "ds": ds, "dv": dv}
    return {k: torch.from_numpy(np.array(jnp.stack(v))) for k, v in out.items()}


def make_batch(seed, b=4, c=96, g=5):
    rng = np.random.default_rng(seed)
    hw = np.stack([rng.integers(40, c, b), rng.integers(40, c, b)], 1).astype(np.float32)
    canvas = np.full((b, c, c, 3), 127, np.uint8)
    for i, (h, w) in enumerate(hw.astype(int)):
        oy, ox = (c - h) // 2, (c - w) // 2
        canvas[i, oy:oy + h, ox:ox + w] = rng.integers(0, 256, (h, w, 3))
    center = rng.uniform(0.05, 0.95, (b, g, 2))
    half = rng.uniform(0.01, 0.3, (b, g, 2))
    yx_min = np.clip(center - half, 0, 1).astype(np.float32)
    yx_max = np.clip(center + half, 0, 1).astype(np.float32)
    valid = rng.uniform(size=(b, g)) < 0.8
    return canvas, hw, yx_min, yx_max, valid


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("ops", sorted(OPS))
def test_apply_with_jax_draws_matches(ops, dtype):
    jdt, tdt = DTYPES[dtype]
    jaug = jtransform.TrainAugment(dtype=jdt, **OPS[ops])
    aug = transform.TrainAugment(dtype=tdt, **OPS[ops])
    key = jax.random.PRNGKey(11)
    batch = make_batch(3)
    size = 64
    want = jaug(key, *batch, size)
    got = aug.apply(*(torch.from_numpy(v) for v in batch), jax_draws(jaug, key, len(batch[0])),
                    size)

    img, want_img = got[0].float().numpy(), np.asarray(want[0], np.float32)
    assert got[0].dtype == tdt and img.shape == want_img.shape == (4, size, size, 3)
    if dtype == "f32":
        np.testing.assert_allclose(img, want_img, rtol=0, atol=5e-5)
    else:
        diff = np.abs(img - want_img)
        assert diff.max() <= 2.0 ** -6 and np.mean(diff <= 2.0 ** -7) >= 0.999, diff.max()
    for i in (1, 2):
        assert got[i].dtype == torch.float32
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


@pytest.mark.parametrize("size", [64, 160])            # a downscale of the crop, an upscale
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_resize_matches_without_antialias(dtype, size):
    """``antialias=False`` (``[transform] antialias = 0``): the triangle keeps
    one input pixel of support, as ``jax.image`` without the prefilter.  The
    crop and the flip, which the resize serves; HSV is left out because in
    bf16 its hue turns a 1-ulp resize difference of a low-chroma pixel into
    up to 0.04 with or without the prefilter (seen at this seed with
    ``antialias=True`` too), which is not what this flag changes."""
    jdt, tdt = DTYPES[dtype]
    jaug = jtransform.TrainAugment(dtype=jdt, antialias=False, hsv=False)
    aug = transform.TrainAugment(dtype=tdt, antialias=False, hsv=False)
    key = jax.random.PRNGKey(13)
    batch = make_batch(5)
    draws = jax_draws(jaug, key, len(batch[0]))
    want = jaug(key, *batch, size)
    got = aug.apply(*(torch.from_numpy(v) for v in batch), draws, size)
    img, want_img = got[0].float().numpy(), np.asarray(want[0], np.float32)
    assert img.shape == want_img.shape == (4, size, size, 3)
    if dtype == "f32":
        np.testing.assert_allclose(img, want_img, rtol=0, atol=5e-5)
    else:
        diff = np.abs(img - want_img)
        assert diff.max() <= 2.0 ** -6 and np.mean(diff <= 2.0 ** -7) >= 0.999, diff.max()
    for i in (1, 2):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    if size == 64:      # the flag is read: on a downscale the prefilter changes the pixels
        smooth = transform.TrainAugment(dtype=tdt, hsv=False).apply(
            *(torch.from_numpy(v) for v in batch), draws, size)[0].float().numpy()
        assert np.abs(smooth - img).max() > 0.05


def test_draw_shapes_and_ranges():
    aug = transform.TrainAugment(jitter=0.3, hue=0.2, saturation=2.0, exposure=1.5)
    d = aug.draw(torch.Generator().manual_seed(0), 500)
    assert d["pads"].shape == (500, 4) and float(d["pads"].abs().max()) <= 0.3
    assert d["flip"].dtype == torch.bool and 0.4 < float(d["flip"].float().mean()) < 0.6
    assert float(d["dh"].abs().max()) <= 0.2
    for k, smax in (("ds", 2.0), ("dv", 1.5)):
        s = torch.where(d[k] >= 1, d[k], 1 / d[k])
        assert float(s.min()) >= 1.0 and float(s.max()) <= smax
        assert 0.4 < float((d[k] >= 1).float().mean()) < 0.6
    again = aug.draw(torch.Generator().manual_seed(0), 500)
    assert all(torch.equal(d[k], again[k]) for k in d)
    assert set(transform.TrainAugment(crop=False, flip=False, hsv=False).draw(
        torch.Generator(), 2)) == set()


def test_colour_space_matches(rng):
    rgb = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    rgb[:20] = rgb[:20, :1]          # gray pixels: d == 0
    rgb[20:30] = 0.0                 # black: mx == 0
    hsv = transform.rgb_to_hsv(torch.from_numpy(rgb))
    np.testing.assert_allclose(hsv.numpy(), np.asarray(jtransform.rgb_to_hsv(rgb)), atol=1e-6)
    np.testing.assert_allclose(transform.hsv_to_rgb(hsv).numpy(),
                               np.asarray(jtransform.hsv_to_rgb(jnp.asarray(hsv.numpy()))),
                               atol=1e-6)
    np.testing.assert_allclose(transform.hsv_to_rgb(hsv).numpy(), rgb, atol=1e-5)


def test_from_config_matches():
    config = configparser.ConfigParser()
    config.read_dict({"transform": {
        "train": "yolojax.data.transform.RandomCrop yolojax.data.transform.HSVJitter",
        "jitter": "0.3", "hue": "0.05", "dtype": "float32"}})
    got, want = transform.TrainAugment.from_config(config), jtransform.TrainAugment.from_config(
        config)
    fields = ("crop", "flip", "hsv", "jitter", "hue", "saturation", "exposure", "flip_prob",
              "antialias")
    for field in fields:
        assert getattr(got, field) == getattr(want, field), field
    assert got.dtype == torch.float32 and not got.flip and got.antialias
    config.set("transform", "antialias", "0")
    got, want = transform.TrainAugment.from_config(config), jtransform.TrainAugment.from_config(
        config)
    for field in fields:
        assert getattr(got, field) == getattr(want, field), field
    assert got.antialias is False
