"""The port's batched augmentation against the JAX package's transforms.

The random streams of torch.Generator and jax.random differ, so every
transform is held at fixed parameters: the same numpy images go through the
JAX transform per sample and the port's batched one, float32, atol 1e-6
(atol 1e-5 where a bilinear resize or the HSV round trip sits in between).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_nested_unet_tpu.data import augment as ja
from pytorch_nested_unet_tpu_torch.data import augment as ta

TOL = dict(atol=1e-6, rtol=0)


def _images(shape=(4, 12, 12, 3), seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def test_rot90_square_matches_jax():
    img = _images()
    k = np.array([0, 1, 2, 3])
    out = ta.rot90(torch.from_numpy(img), torch.from_numpy(k))
    for i in range(len(img)):
        ref = ja._rot90_square(jnp.asarray(img[i]), int(k[i]))
        np.testing.assert_allclose(out[i].numpy(), np.asarray(ref), **TOL)


def test_rot90_rect_matches_jax():
    img = _images((4, 8, 12, 3), seed=1)
    k = np.array([0, 1, 2, 3])
    out = ta.rot90(torch.from_numpy(img), torch.from_numpy(k))
    assert out.shape == img.shape
    for i in range(len(img)):
        ref = ja._rot90_rect(jnp.asarray(img[i]), jnp.asarray(k[i]))
        np.testing.assert_allclose(out[i].numpy(), np.asarray(ref), atol=1e-5)


def test_flips_match_jax():
    img = _images(seed=2)
    do_ud = np.array([True, False, True, False])
    do_lr = np.array([True, True, False, False])
    out = ta.flip(torch.from_numpy(img), torch.from_numpy(do_ud), torch.from_numpy(do_lr))
    for i in range(len(img)):
        ref = img[i]
        ref = ref[::-1] if do_ud[i] else ref
        ref = ref[:, ::-1] if do_lr[i] else ref
        np.testing.assert_allclose(out[i].numpy(), ref, **TOL)


def test_hsv_round_trip_and_ties_match_jax():
    img = _images((2, 8, 8, 3), seed=3)
    img[0, 0, 0] = [0.5, 0.5, 0.2]   # r == g: the v == r branch wins
    img[0, 0, 1] = [0.3, 0.7, 0.7]   # g == b
    img[0, 0, 2] = [0.4, 0.4, 0.4]   # grey: c == 0
    img[0, 0, 3] = [0.0, 0.0, 0.0]   # black: v == 0
    h, s, v = ta.rgb_to_hsv(torch.from_numpy(img))
    jh, js, jv = ja.rgb_to_hsv(jnp.asarray(img))
    for got, ref in ((h, jh), (s, js), (v, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    back = ta.hsv_to_rgb(h, s, v)
    np.testing.assert_allclose(back.numpy(), np.asarray(ja.hsv_to_rgb(jh, js, jv)), **TOL)
    np.testing.assert_allclose(back.numpy(), img, atol=1e-5)


def _jax_color(img, fn_name, value):
    """The JAX color op at a fixed parameter (its draw replaced by `value`)."""
    x = jnp.asarray(img)
    if fn_name == "brightness":
        return jnp.clip(x + value, 0.0, 1.0)
    if fn_name == "contrast":
        return jnp.clip(x * value, 0.0, 1.0)
    hue, sat, val = value
    h, s, v = ja.rgb_to_hsv(x)
    h = (h + hue) % 1.0
    s = jnp.clip(s + sat, 0.0, 1.0)
    v = jnp.clip(v + val, 0.0, 1.0)
    return ja.hsv_to_rgb(h, s, v)


def test_color_ops_match_jax():
    img = _images(seed=4)
    t = torch.from_numpy
    beta = np.array([-0.2, -0.05, 0.1, 0.2], np.float32)
    alpha = np.array([0.8, 0.95, 1.1, 1.2], np.float32)
    hue = np.array([-20, -3, 7, 20], np.float32) / 180
    sat = np.array([-30, 0, 12, 30], np.float32) / 255
    val = np.array([-20, 5, 0, 20], np.float32) / 255
    out_b = ta.brightness(t(img), t(beta))
    out_c = ta.contrast(t(img), t(alpha))
    out_h = ta.hsv_shift(t(img), t(hue), t(sat), t(val))
    for i in range(len(img)):
        np.testing.assert_allclose(out_b[i].numpy(),
                                   np.asarray(_jax_color(img[i], "brightness", beta[i])), **TOL)
        np.testing.assert_allclose(out_c[i].numpy(),
                                   np.asarray(_jax_color(img[i], "contrast", alpha[i])), **TOL)
        np.testing.assert_allclose(out_h[i].numpy(), np.asarray(_jax_color(
            img[i], "hsv", (hue[i], sat[i], val[i]))), atol=1e-5)


def test_normalize_and_eval_transform_match_jax():
    u8 = np.random.default_rng(5).integers(0, 256, (2, 6, 6, 3), dtype=np.uint8)
    m8 = (np.random.default_rng(6).random((2, 6, 6, 1)) > 0.5).astype(np.uint8) * 255
    img, mask = ta.eval_transform(torch.from_numpy(u8), torch.from_numpy(m8))
    jimg, jmask = ja.eval_transform(jnp.asarray(u8), jnp.asarray(m8))
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), **TOL)
    np.testing.assert_allclose(mask.numpy(), np.asarray(jmask), **TOL)


def test_parse_augment_spec_matches_jax():
    for spec in ("full", "none", "", True, False, None, "flip, rot90,flip",
                 ("contrast", "hsv"), "brightness"):
        assert ta.parse_augment_spec(spec) == ja.parse_augment_spec(spec)
    assert ta.AUGMENT_OPS == ja.AUGMENT_OPS
    with pytest.raises(ValueError, match="bogus"):
        ta.parse_augment_spec("flip,bogus")


def _u8_batch(seed=7, b=4):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, 10, 10, 3), dtype=np.uint8)
    masks = (rng.random((b, 10, 10, 1)) > 0.5).astype(np.uint8) * 255
    return torch.from_numpy(imgs), torch.from_numpy(masks)


def test_same_seed_same_draws_and_none_is_eval():
    imgs, masks = _u8_batch()

    def run(seed, ops="full"):
        return ta.augment_batch(imgs, masks, ops, torch.Generator().manual_seed(seed))

    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    none = run(3, "none")
    ev = ta.eval_transform(imgs, masks)
    assert torch.equal(none[0], ev[0]) and torch.equal(none[1], ev[1])
    # geometry keeps masks binary; a draw's geometry is the same whatever colour ops run
    geo = run(3, "rot90,flip")
    assert set(np.unique(geo[1].numpy())) <= {0.0, 1.0}
    assert torch.equal(geo[1], a[1])


def test_apply_augment_at_fixed_params_matches_jax_ops():
    """The whole pipeline at fixed draws: rot90, flip, then the chosen colour op."""
    imgs, masks = _u8_batch(seed=8)
    img = imgs.float() / 255
    mask = masks.float() / 255
    b = len(img)
    params = {"rot_apply": torch.tensor([True, True, False, True]),
              "rot_k": torch.tensor([1, 2, 3, 3]),
              "flip_apply": torch.tensor([True, False, True, True]),
              "flip_d": torch.tensor([-1, 0, 1, 0]),
              "color_u": torch.tensor([0.1, 0.5, 0.9, 0.4]),
              "hue": torch.full((b,), 0.05), "sat": torch.full((b,), -0.1),
              "val": torch.full((b,), 0.02), "brightness": torch.full((b,), 0.1),
              "contrast": torch.full((b,), 0.9)}
    out, out_mask = ta.apply_augment(img, mask, ta.AUGMENT_OPS, params)
    pool = ("hsv", "brightness", "contrast")
    for i in range(b):
        x, m = jnp.asarray(img[i].numpy()), jnp.asarray(mask[i].numpy())
        k = int(params["rot_k"][i]) if params["rot_apply"][i] else 0
        x, m = ja._rot90_square(x, k), ja._rot90_square(m, k)
        d, app = int(params["flip_d"][i]), bool(params["flip_apply"][i])
        if app and d <= 0:
            x, m = x[::-1], m[::-1]
        if app and d != 0:
            x, m = x[:, ::-1], m[:, ::-1]
        op = pool[min(int(float(params["color_u"][i]) * 3), 2)]
        value = {"hsv": (0.05, -0.1, 0.02), "brightness": 0.1, "contrast": 0.9}[op]
        ref = _jax_color(np.asarray(x), op, np.float32(value) if op != "hsv" else value)
        np.testing.assert_allclose(out[i].numpy(), np.asarray(ref), atol=1e-5)
        np.testing.assert_allclose(out_mask[i].numpy(), np.asarray(m), **TOL)
