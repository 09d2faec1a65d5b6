"""BatchNorm2d + ReLU over NHWC tensors (counterpart of ops/fused_bn.py).

Eval mode normalizes with the running statistics (the JAX module's
running-stat branch, :341-344). Train mode normalizes with the batch
statistics through `BNReLUTrain`, the counterpart of the JAX custom VJP
`fused_bn_relu_train` (:203-299), on three kernels over the (N*H*W, C) view:

- K1 `bn_stats`: per-channel sum x and sum x^2, then mean, biased variance,
  rsqrt(var + eps) and the running-stat update (JAX: `bn_stats`, :145-173);
- K2 `bn_bwd_reduce`: [sum dz, sum dz*xhat] = [dbeta, dgamma], with xhat and
  the ReLU mask recomputed from x (JAX: `_bwd_reduce_kernel`, :114-124);
- K3 `bn_bwd_dx`: dx = gamma*inv * (dz - dbeta/n - xhat*dgamma/n) (JAX:
  `_bwd_dx_kernel`, :127-134).

On CUDA tensors each wrapper launches its kernel in `csrc/fused_bn.cu` (any C
and row count; no shape guard, no fall-back). On CPU tensors it runs the
plain version beside it (`reference_bn_*`), which the tests hold against the
JAX package. The normalize+ReLU pass between K1 and K2 is plain elementwise
torch, as it is plain XLA in JAX (:223-225).
"""

import contextlib
import ctypes
import threading
from typing import Optional

import torch
import torch.nn as nn

from . import _build

# Launches of each kernel; chip_smoke.py zeroes them before driving the
# training path and reads them after.
LAUNCHES = {"bn_stats": 0, "bn_bwd_reduce": 0, "bn_bwd_dx": 0}

MOMENTUM = 0.9  # running-stat decay (torch momentum 0.1)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None
_P, _I, _LL, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
# The C interface of csrc/fused_bn.cu, argument by argument (the CPU tests
# hold it against the source's extern "C" signatures).
ARGTYPES = {
    "bn_stats": [_I, _P, _LL, _I, _D, _D, _P, _LL, _P, _I, _I, _P, _P, _P, _P],
    "bn_bwd_reduce": [_I, _P, _P, _LL, _I, _P, _P, _P, _P, _P, _LL, _P, _I, _I, _P, _P],
    "bn_bwd_dx": [_I, _P, _P, _LL, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P],
}
# Per device: one zeroed int32 ticket buffer, shared by K1 and K2. Both
# kernels leave their tickets at 0, so the buffer is made once and every later
# call, a CUDA graph's replay included, reuses it. One buffer is safe because
# the calls that share it run in stream order: K1 in the forward and K2 in the
# backward of a step are queued on one stream, and a kernel starts only after
# the one before it has reset its tickets (csrc/fused_bn.cu). A buffer of its
# own for K1 would be no safer: two K1 calls on two streams at once would
# still share one.
_TICKETS = {}
_SMS = {}  # SM count per device


# ---------------------------------------------------------------- plain versions

def reference_bn_stats(x2d: torch.Tensor, eps: float = 1e-5,
                       running_mean: Optional[torch.Tensor] = None,
                       running_var: Optional[torch.Tensor] = None,
                       momentum: float = MOMENTUM):
    """Plain K1: (sum, sumsq, mean, biased var, inv) of the (n, C) view, f32.

    With running stats given, updates them in place: run = momentum*run +
    (1 - momentum)*stat, the variance taken unbiased (times n/(n-1)).
    """
    n = x2d.shape[0]
    xf = x2d.to(torch.float32)
    s, ss = xf.sum(0), (xf * xf).sum(0)
    mean = s / n
    var = torch.clamp(ss / n - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    if running_mean is not None:
        running_mean.copy_(momentum * running_mean + (1 - momentum) * mean)
        running_var.copy_(momentum * running_var
                          + (1 - momentum) * (var * (n / max(n - 1, 1))))
    return s, ss, mean, var, inv


def _xhat_dz(x2d, dy2d, mean, inv, gamma, beta):
    """xhat and the ReLU-masked gradient dz, as `_dz_common` computes them."""
    xhat = (x2d.to(torch.float32) - mean) * inv
    dz = torch.where(gamma * xhat + beta > 0.0, dy2d.to(torch.float32), 0.0)
    return xhat, dz


def reference_bn_bwd_reduce(x2d, dy2d, mean, inv, gamma, beta):
    """Plain K2: (dbeta, dgamma) = per-channel (sum dz, sum dz*xhat), f32."""
    xhat, dz = _xhat_dz(x2d, dy2d, mean, inv, gamma, beta)
    return dz.sum(0), (dz * xhat).sum(0)


def reference_bn_bwd_dx(x2d, dy2d, mean, inv, gamma, beta, dbeta, dgamma):
    """Plain K3: dx = gamma*inv * (dz - dbeta/n - xhat*dgamma/n) in x's dtype."""
    n = float(x2d.shape[0])
    xhat, dz = _xhat_dz(x2d, dy2d, mean, inv, gamma, beta)
    dx = (gamma * inv) * (dz - dbeta / n - xhat * dgamma / n)
    return dx.to(x2d.dtype)


# ---------------------------------------------------------------- kernels

def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("fused_bn")
        for name, argtypes in ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, _I
        _LIB = lib
    return _LIB


def _is_cpu(*tensors) -> bool:
    return all(t is None or t.device.type == "cpu" for t in tensors)


def _check(name, x2d, rows_like=(), vectors=()):
    """Validate the CUDA call: 2-D contiguous (rows, C) activations of one
    dtype, contiguous float32 [C] vectors, all on x2d's device."""
    if x2d.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x2d.device}")
    if x2d.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x2d.dtype} not supported (float32, bfloat16)")
    if x2d.dim() != 2 or not x2d.is_contiguous() or x2d.shape[0] < 1 or x2d.shape[1] < 1:
        raise ValueError(f"{name}: x must be a contiguous non-empty (rows, C) view, "
                         f"got {tuple(x2d.shape)}")
    for t in rows_like:
        if t.device != x2d.device or t.dtype != x2d.dtype or t.shape != x2d.shape \
                or not t.is_contiguous():
            raise ValueError(f"{name}: dy must be contiguous {tuple(x2d.shape)} "
                             f"{x2d.dtype} on {x2d.device}")
    c = x2d.shape[1]
    for t in vectors:
        if t is None:
            continue
        if t.device != x2d.device or t.dtype != torch.float32 or tuple(t.shape) != (c,) \
                or not t.is_contiguous():
            raise ValueError(f"{name}: per-channel vectors must be contiguous float32 "
                             f"({c},) on {x2d.device}")
    return x2d.shape[0], c


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _sms(dev):
    sms = _SMS.get(dev.index)
    if sms is None:
        sms = _SMS[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms


def _reduce_scratch(name, dev, c):
    """K1's or K2's scratch on `dev`: (work, work_floats, tickets, sms). The
    ticket buffer (at least ceil(c / 32) zeroed ints) is made at first use;
    growing it is one zero fill, never inside a CUDA graph capture."""
    sms = _sms(dev)
    need = -(-c // 32)
    tickets = _TICKETS.get(dev.index)
    if tickets is None or tickets.numel() < need:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{name}: call bn_stats or bn_bwd_reduce once on this device "
                               "(at this channel count or more) before capturing a CUDA graph")
        tickets = _TICKETS[dev.index] = torch.zeros(max(need, 64), dtype=torch.int32,
                                                    device=dev)
    work_floats = 128 * max(2 * sms, c)
    work = torch.empty(work_floats, dtype=torch.float32, device=dev)
    return work, work_floats, tickets, sms


def bn_stats(x2d: torch.Tensor, eps: float = 1e-5,
             running_mean: Optional[torch.Tensor] = None,
             running_var: Optional[torch.Tensor] = None, momentum: float = MOMENTUM):
    """K1: (sum, sumsq, mean, biased var, inv), float32 [C] each, of the
    (rows, C) view; updates the running stats in place when given.

    CUDA tensors: the kernel (one launch, no float atomics). CPU tensors:
    `reference_bn_stats`.
    """
    if _is_cpu(x2d, running_mean, running_var):
        return reference_bn_stats(x2d, eps, running_mean, running_var, momentum)
    rows, c = _check("bn_stats", x2d, vectors=(running_mean, running_var))
    if (running_mean is None) != (running_var is None):
        raise ValueError("bn_stats: give both running stats or neither")
    dev = x2d.device
    work, work_floats, tickets, sms = _reduce_scratch("bn_stats", dev, c)
    out = torch.empty((5, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().bn_stats(
            _DTYPE_CODE[x2d.dtype], x2d.data_ptr(), rows, c, eps, momentum,
            work.data_ptr(), work_floats, tickets.data_ptr(), tickets.numel(), sms,
            out.data_ptr(), None if running_mean is None else running_mean.data_ptr(),
            None if running_var is None else running_var.data_ptr(), _stream(dev))
    _raise_on(err, "bn_stats")
    LAUNCHES["bn_stats"] += 1
    return tuple(out.unbind(0))


def bn_bwd_reduce(x2d, dy2d, mean, inv, gamma, beta):
    """K2: (dbeta, dgamma) in float32, xhat and the ReLU mask recomputed from
    x. CUDA tensors: the kernel, one launch per call; CPU tensors:
    `reference_bn_bwd_reduce`."""
    if _is_cpu(x2d, dy2d, mean, inv, gamma, beta):
        return reference_bn_bwd_reduce(x2d, dy2d, mean, inv, gamma, beta)
    rows, c = _check("bn_bwd_reduce", x2d, (dy2d,), (mean, inv, gamma, beta))
    dev = x2d.device
    work, work_floats, tickets, sms = _reduce_scratch("bn_bwd_reduce", dev, c)
    out = torch.empty((2, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().bn_bwd_reduce(
            _DTYPE_CODE[x2d.dtype], x2d.data_ptr(), dy2d.data_ptr(), rows, c,
            mean.data_ptr(), inv.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            work.data_ptr(), work_floats, tickets.data_ptr(), tickets.numel(), sms,
            out.data_ptr(), _stream(dev))
    _raise_on(err, "bn_bwd_reduce")
    LAUNCHES["bn_bwd_reduce"] += 1
    return out[0], out[1]


def bn_bwd_dx(x2d, dy2d, mean, inv, gamma, beta, dbeta, dgamma):
    """K3: dx in x's dtype. CUDA tensors: the kernel; CPU tensors:
    `reference_bn_bwd_dx`."""
    if _is_cpu(x2d, dy2d, mean, inv, gamma, beta, dbeta, dgamma):
        return reference_bn_bwd_dx(x2d, dy2d, mean, inv, gamma, beta, dbeta, dgamma)
    rows, c = _check("bn_bwd_dx", x2d, (dy2d,), (mean, inv, gamma, beta, dbeta, dgamma))
    dev = x2d.device
    dx = torch.empty_like(x2d)
    with torch.cuda.device(dev):
        err = _lib().bn_bwd_dx(
            _DTYPE_CODE[x2d.dtype], x2d.data_ptr(), dy2d.data_ptr(), rows, c,
            mean.data_ptr(), inv.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            dbeta.data_ptr(), dgamma.data_ptr(), dx.data_ptr(), _sms(dev), _stream(dev))
    _raise_on(err, "bn_bwd_dx")
    LAUNCHES["bn_bwd_dx"] += 1
    return dx


# ---------------------------------------------------------------- autograd

def bn_relu(x, mean, inv, gamma, beta):
    """The normalize + ReLU pass of a train-mode step: relu((x - mean) *
    (inv*gamma) + beta) in f32, cast to x's dtype. `BNReLUTrain` runs it
    after K1, and the "policy" rematerialization of VGGBlock runs it again
    in backward on the same saved tensors, so the two agree bit for bit."""
    return torch.relu((x.to(torch.float32) - mean) * (inv * gamma) + beta).to(x.dtype)


class _Recomputing(threading.local):
    active = False


_RECOMPUTING = _Recomputing()


@contextlib.contextmanager
def recomputing():
    """The context of a rematerialized forward (`torch.utils.checkpoint`'s
    recompute): inside it `FusedBatchNormReLU` runs K1 without the running
    statistics, so a step updates them once, in its first forward. Per
    thread, as autograd runs a CUDA backward on a thread of its own."""
    before, _RECOMPUTING.active = _RECOMPUTING.active, True
    try:
        yield
    finally:
        _RECOMPUTING.active = before


class BNReLUTrain(torch.autograd.Function):
    """Training-mode BN + ReLU on NHWC x -> (y, batch mean, biased batch var,
    inv = rsqrt(var + eps)).

    Forward: K1, then y = `bn_relu(x, mean, inv, gamma, beta)`; the running
    stats (when given) are updated by K1. Saves (x, mean, inv, gamma, beta),
    not the pre-activation. Backward: K2 then K3; the mean, var and inv
    outputs take no gradient (JAX: :237).
    """

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, running_mean, running_var, momentum):
        c = x.shape[-1]
        x = x.contiguous()
        _, _, mean, var, inv = bn_stats(x.view(-1, c), eps, running_mean, running_var,
                                        momentum)
        y = bn_relu(x, mean, inv, gamma, beta)
        ctx.save_for_backward(x, mean, inv, gamma, beta)
        ctx.mark_non_differentiable(mean, var, inv)
        return y, mean, var, inv

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar, _dinv):
        x, mean, inv, gamma, beta = ctx.saved_tensors
        c = x.shape[-1]
        x2d = x.view(-1, c)
        dy2d = dy.to(x.dtype).contiguous().view(-1, c)
        dbeta, dgamma = bn_bwd_reduce(x2d, dy2d, mean, inv, gamma, beta)
        dx = bn_bwd_dx(x2d, dy2d, mean, inv, gamma, beta, dbeta, dgamma)
        return dx.view(x.shape), dgamma, dbeta, None, None, None, None


def fused_bn_relu_train(x, gamma, beta, eps: float = 1e-5, running_mean=None,
                        running_var=None, momentum: float = MOMENTUM):
    """Training-mode BN + ReLU: (y, mean, var), as JAX's fused_bn_relu_train."""
    return BNReLUTrain.apply(x, gamma, beta, eps, running_mean, running_var, momentum)[:3]


class FusedBatchNormReLU(nn.Module):
    """BatchNorm2d + ReLU with torch semantics: momentum 0.1 (decay 0.9), eps
    1e-5, float32 weight/bias/statistics, unbiased running variance.

    Train mode: batch statistics through `BNReLUTrain` (K1-K3), and the running
    stats updated in place (not inside `recomputing()`). Eval mode: relu((x - running_mean) *
    rsqrt(running_var + eps) * weight + bias). The math runs in float32 and the
    result is cast to `dtype` (or to the input's dtype when `dtype` is None).
    """

    def __init__(self, num_features: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def train_forward(self, x: torch.Tensor):
        """Train mode: (y, mean, inv), y in the output dtype."""
        stats = (None, None) if _RECOMPUTING.active else (self.running_mean, self.running_var)
        y, mean, _, inv = BNReLUTrain.apply(x, self.weight, self.bias, self.eps, *stats,
                                            MOMENTUM)
        return y.to(self.dtype or x.dtype), mean, inv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_dtype = self.dtype or x.dtype
        if self.training:
            return self.train_forward(x)[0]
        scale = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.to(torch.float32) - self.running_mean) * scale + self.bias
        return torch.relu(y).to(out_dtype)
