"""The port on a CUDA card: each kernel against its plain version, and the
model on the card against the same weights on the CPU.

Every test carries the `cuda` marker and skips on a host without CUDA (the
`cuda` fixture decides, at run time). This file imports no JAX, so on a
machine that has the card but no JAX it runs without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pytorch_nested_unet_tpu_torch.infer import Predictor
from pytorch_nested_unet_tpu_torch.ops import decoder_fusion as df

pytestmark = pytest.mark.cuda

NARROW = (4, 8, 16, 32, 64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, cps, co, hw, dev, dtype, batch=2):
    g = torch.Generator().manual_seed(seed)
    parts = [torch.randn(batch, *hw, c, generator=g).to(dev, dtype) for c in cps]
    kernel = (torch.randn(3, 3, sum(cps), co, generator=g) * 0.1).to(dev, dtype)
    bias = torch.randn(co, generator=g).to(dev)
    return parts, kernel, bias


# f32: summation order over K = 9*cin; bf16: one rounding of the output, and the
# plain version adds the bias after that rounding where the kernel adds it before.
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("cps,co,hw", [
    ((5, 3, 8), 6, (13, 10)), ((7,), 4, (1, 1)), ((32, 32, 64), 32, (24, 24)),
    ((64, 128), 70, (9, 17)), ((1,) * 8, 3, (5, 33)),
])
def test_multipart_conv3x3_kernel(cuda, dtype, tol, cps, co, hw):
    parts, kernel, bias = _inputs(0, cps, co, hw, cuda, dtype)
    before = df.LAUNCHES
    out = df.multipart_conv3x3(parts, kernel, bias)
    torch.cuda.synchronize()
    assert df.LAUNCHES == before + 1
    assert out.dtype == dtype and out.is_contiguous()
    ref = df.reference_multipart_conv3x3([p.float() for p in parts], kernel.float(), bias)
    torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)
    nobias = df.multipart_conv3x3(parts, kernel)
    ref0 = df.reference_multipart_conv3x3([p.float() for p in parts], kernel.float())
    torch.testing.assert_close(nobias.float(), ref0, atol=tol, rtol=tol)


def test_multipart_conv3x3_rejects_bad_inputs(cuda):
    parts, kernel, bias = _inputs(1, (4, 4), 8, (6, 6), cuda, torch.float32)
    with pytest.raises(ValueError):  # not NHWC-contiguous
        df.multipart_conv3x3([parts[0].transpose(1, 2), parts[1]], kernel, bias)
    with pytest.raises(ValueError):  # kernel dtype differs
        df.multipart_conv3x3(parts, kernel.bfloat16(), bias)
    with pytest.raises(ValueError):  # mixed devices
        df.multipart_conv3x3(parts, kernel.cpu(), bias)
    with pytest.raises(TypeError):
        df.multipart_conv3x3([p.half() for p in parts], kernel.half(), bias)


def test_predictor_cuda_matches_cpu(cuda):
    images = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    kw = dict(deep_supervision=True, batch_size=2, arch_kwargs={"nb_filter": NARROW})
    gpu = Predictor(device="cuda", **kw)
    before = df.LAUNCHES
    out = gpu.predict_u8(images)
    assert df.LAUNCHES - before == 10 * 2  # 10 decoder nodes x 2 batches
    sd = {k: v.cpu() for k, v in gpu.model.state_dict().items()}
    ref = Predictor(device="cpu", weights=sd, **kw).predict_u8(images)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
