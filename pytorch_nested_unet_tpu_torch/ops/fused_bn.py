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

Data-parallel training (a module's `process_group`, set by
`parallel.mesh.sync_batch_norm`) takes the moments over every rank's rows, as
the JAX package's BN does over a batch sharded under GSPMD: K1 runs in its
sums-only mode (`bn_sums`), one all-reduce adds the (2, C) sums, and
`bn_finish` makes mean, var, inv and the running-stat update from them and
the global row count; in backward K2's (2, C) output is all-reduced and K3
divides by the global row count. The parameters' gradients stay the rank's
own (the optimizer averages them across ranks).

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
import torch.distributed as dist
import torch.nn as nn

from . import _build

# Launches of each kernel; chip_smoke.py zeroes them before driving the
# training path and reads them after.
LAUNCHES = {"bn_stats": 0, "bn_bwd_reduce": 0, "bn_bwd_dx": 0, "bn_finish": 0}

MOMENTUM = 0.9  # running-stat decay (torch momentum 0.1)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB = None
_P, _I, _LL, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
# The C interface of csrc/fused_bn.cu, argument by argument (the CPU tests
# hold it against the source's extern "C" signatures).
ARGTYPES = {
    "bn_stats": [_I, _P, _LL, _I, _D, _D, _I, _P, _LL, _P, _I, _I, _P, _P, _P, _P],
    "bn_finish": [_P, _LL, _I, _D, _D, _P, _P, _P, _P],
    "bn_bwd_reduce": [_I, _P, _P, _LL, _I, _P, _P, _P, _P, _P, _LL, _P, _I, _I, _P, _P],
    "bn_bwd_dx": [_I, _P, _P, _LL, _LL, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P],
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

def reference_bn_sums(x2d: torch.Tensor):
    """Plain K1 in its sums-only mode: (sum, sumsq) of the (n, C) view, f32."""
    xf = x2d.to(torch.float32)
    return xf.sum(0), (xf * xf).sum(0)


def reference_bn_finish(s, ss, n: int, eps: float = 1e-5,
                        running_mean: Optional[torch.Tensor] = None,
                        running_var: Optional[torch.Tensor] = None,
                        momentum: float = MOMENTUM):
    """Plain bn_finish: (mean, biased var, inv) from the sums over n rows;
    with running stats given, updates them in place: run = momentum*run +
    (1 - momentum)*stat, the variance taken unbiased (times n/(n-1))."""
    mean = s / n
    var = torch.clamp(ss / n - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    if running_mean is not None:
        running_mean.copy_(momentum * running_mean + (1 - momentum) * mean)
        running_var.copy_(momentum * running_var
                          + (1 - momentum) * (var * (n / max(n - 1, 1))))
    return mean, var, inv


def reference_bn_stats(x2d: torch.Tensor, eps: float = 1e-5,
                       running_mean: Optional[torch.Tensor] = None,
                       running_var: Optional[torch.Tensor] = None,
                       momentum: float = MOMENTUM):
    """Plain K1: (sum, sumsq, mean, biased var, inv) of the (n, C) view, f32,
    the running stats updated as `reference_bn_finish` does."""
    s, ss = reference_bn_sums(x2d)
    return (s, ss, *reference_bn_finish(s, ss, x2d.shape[0], eps, running_mean,
                                         running_var, momentum))


def _xhat_dz(x2d, dy2d, mean, inv, gamma, beta):
    """xhat and the ReLU-masked gradient dz, as `_dz_common` computes them."""
    xhat = (x2d.to(torch.float32) - mean) * inv
    dz = torch.where(gamma * xhat + beta > 0.0, dy2d.to(torch.float32), 0.0)
    return xhat, dz


def reference_bn_bwd_reduce(x2d, dy2d, mean, inv, gamma, beta):
    """Plain K2: (dbeta, dgamma) = per-channel (sum dz, sum dz*xhat), f32."""
    xhat, dz = _xhat_dz(x2d, dy2d, mean, inv, gamma, beta)
    return dz.sum(0), (dz * xhat).sum(0)


def reference_bn_bwd_dx(x2d, dy2d, mean, inv, gamma, beta, dbeta, dgamma, n=None):
    """Plain K3: dx = gamma*inv * (dz - dbeta/n - xhat*dgamma/n) in x's dtype;
    n defaults to x's rows."""
    n = float(x2d.shape[0] if n is None else n)
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


def _check(name, x2d, rows_like=(), vectors=(), empty=False):
    """Validate the CUDA call: 2-D contiguous (rows, C) activations of one
    dtype (`empty`: rows may be 0, a band of zero rows on the 'x'/'y' mesh
    axes), contiguous float32 [C] vectors, all on x2d's device."""
    if x2d.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x2d.device}")
    if x2d.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x2d.dtype} not supported (float32, bfloat16)")
    if x2d.dim() != 2 or not x2d.is_contiguous() or x2d.shape[0] < (0 if empty else 1) \
            or x2d.shape[1] < 1:
        raise ValueError(f"{name}: x must be a contiguous (rows, C) view with C >= 1 and "
                         f"{'rows >= 0' if empty else 'rows >= 1'}, got {tuple(x2d.shape)}")
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


def _launch_stats(x2d, eps, running_mean, running_var, momentum, sums_only):
    rows, c = _check("bn_stats", x2d, vectors=(running_mean, running_var), empty=sums_only)
    if (running_mean is None) != (running_var is None):
        raise ValueError("bn_stats: give both running stats or neither")
    dev = x2d.device
    work, work_floats, tickets, sms = _reduce_scratch("bn_stats", dev, c)
    out = torch.empty((2 if sums_only else 5, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().bn_stats(
            _DTYPE_CODE[x2d.dtype], x2d.data_ptr(), rows, c, eps, momentum, int(sums_only),
            work.data_ptr(), work_floats, tickets.data_ptr(), tickets.numel(), sms,
            out.data_ptr(), None if running_mean is None else running_mean.data_ptr(),
            None if running_var is None else running_var.data_ptr(), _stream(dev))
    _raise_on(err, "bn_stats")
    LAUNCHES["bn_stats"] += 1
    return out


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
    return tuple(_launch_stats(x2d, eps, running_mean, running_var, momentum, False).unbind(0))


def bn_sums(x2d: torch.Tensor) -> torch.Tensor:
    """K1 in its sums-only mode: float32 [2, C] = (sum, sumsq) of the (rows, C)
    view, one buffer for the all-reduce of data-parallel training; zeros for
    0 rows (an empty band). CUDA tensors: the kernel (one launch, counted as
    a `bn_stats` launch); CPU tensors: `reference_bn_sums`."""
    if _is_cpu(x2d):
        return torch.stack(reference_bn_sums(x2d))
    return _launch_stats(x2d, 1e-5, None, None, MOMENTUM, True)


def bn_finish(sums: torch.Tensor, n: int, eps: float = 1e-5,
              running_mean: Optional[torch.Tensor] = None,
              running_var: Optional[torch.Tensor] = None, momentum: float = MOMENTUM):
    """K1's finish from float32 [2, C] sums over n rows: (mean, biased var,
    inv), float32 [C] each, the running stats updated in place when given.
    CUDA tensors: one launch; CPU tensors: `reference_bn_finish`."""
    if _is_cpu(sums, running_mean, running_var):
        return reference_bn_finish(sums[0], sums[1], n, eps, running_mean, running_var,
                                   momentum)
    _, c = _check("bn_finish", sums, vectors=(running_mean, running_var))
    if sums.dtype != torch.float32 or sums.shape[0] != 2:
        raise ValueError(f"bn_finish: sums must be float32 (2, C), got {sums.dtype} "
                         f"{tuple(sums.shape)}")
    if (running_mean is None) != (running_var is None):
        raise ValueError("bn_finish: give both running stats or neither")
    dev = sums.device
    out = torch.empty((3, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().bn_finish(
            sums.data_ptr(), int(n), c, eps, momentum, out.data_ptr(),
            None if running_mean is None else running_mean.data_ptr(),
            None if running_var is None else running_var.data_ptr(), _stream(dev))
    _raise_on(err, "bn_finish")
    LAUNCHES["bn_finish"] += 1
    return tuple(out.unbind(0))


def bn_bwd_reduce_sums(x2d, dy2d, mean, inv, gamma, beta) -> torch.Tensor:
    """K2 as one float32 [2, C] buffer = (dbeta, dgamma), for the all-reduce
    of data-parallel training (zeros for 0 rows). CUDA tensors: the kernel,
    one launch per call; CPU tensors: `reference_bn_bwd_reduce`."""
    if _is_cpu(x2d, dy2d, mean, inv, gamma, beta):
        return torch.stack(reference_bn_bwd_reduce(x2d, dy2d, mean, inv, gamma, beta))
    rows, c = _check("bn_bwd_reduce", x2d, (dy2d,), (mean, inv, gamma, beta), empty=True)
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
    return out


def bn_bwd_reduce(x2d, dy2d, mean, inv, gamma, beta):
    """K2: (dbeta, dgamma) in float32, xhat and the ReLU mask recomputed from
    x. CUDA tensors: the kernel, one launch per call; CPU tensors:
    `reference_bn_bwd_reduce`."""
    if _is_cpu(x2d, dy2d, mean, inv, gamma, beta):
        return reference_bn_bwd_reduce(x2d, dy2d, mean, inv, gamma, beta)
    out = bn_bwd_reduce_sums(x2d, dy2d, mean, inv, gamma, beta)
    return out[0], out[1]


def bn_bwd_dx(x2d, dy2d, mean, inv, gamma, beta, dbeta, dgamma, n=None):
    """K3: dx in x's dtype, dbeta and dgamma divided by n (default: x's rows;
    all ranks' rows in data-parallel training; 0 rows of x give an empty dx,
    still one launch). CUDA tensors: the kernel; CPU tensors:
    `reference_bn_bwd_dx`."""
    if _is_cpu(x2d, dy2d, mean, inv, gamma, beta, dbeta, dgamma):
        return reference_bn_bwd_dx(x2d, dy2d, mean, inv, gamma, beta, dbeta, dgamma, n)
    rows, c = _check("bn_bwd_dx", x2d, (dy2d,), (mean, inv, gamma, beta, dbeta, dgamma),
                     empty=True)
    n = rows if n is None else int(n)
    if n < rows:
        raise ValueError(f"bn_bwd_dx: n = {n} is below the {rows} rows of x")
    dev = x2d.device
    dx = torch.empty_like(x2d)
    with torch.cuda.device(dev):
        err = _lib().bn_bwd_dx(
            _DTYPE_CODE[x2d.dtype], x2d.data_ptr(), dy2d.data_ptr(), rows, n, c,
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

    With a process `group`, the statistics are those of every rank's rows
    (equal row counts): K1's sums all-reduced, then `bn_finish` over the
    global row count; in backward K2's output all-reduced for K3, while
    dgamma and dbeta stay this rank's own. The global count is `n`, or rows
    * world size (equal row counts) when n is None. Under the 'x'/'y' mesh
    axes the group is the whole world, a rank's rows are its band's pixels,
    and n is the whole map's pixels over every data row (the module's
    `bands`): bands may be unequal or empty, and an empty band's K1, K2 and
    K3 still launch once each (zero sums, an empty dx).
    """

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, running_mean, running_var, momentum, group=None,
                n=None):
        c = x.shape[-1]
        x = x.contiguous()
        x2d = x.view(-1, c)
        if group is None:
            n = x2d.shape[0]
            _, _, mean, var, inv = bn_stats(x2d, eps, running_mean, running_var, momentum)
        else:
            sums = bn_sums(x2d)
            dist.all_reduce(sums, group=group)
            n = x2d.shape[0] * dist.get_world_size(group) if n is None else int(n)
            mean, var, inv = bn_finish(sums, n, eps, running_mean, running_var, momentum)
        y = bn_relu(x, mean, inv, gamma, beta)
        ctx.save_for_backward(x, mean, inv, gamma, beta)
        ctx.group, ctx.n = group, n
        ctx.mark_non_differentiable(mean, var, inv)
        return y, mean, var, inv

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar, _dinv):
        x, mean, inv, gamma, beta = ctx.saved_tensors
        c = x.shape[-1]
        x2d = x.view(-1, c)
        dy2d = dy.to(x.dtype).contiguous().view(-1, c)
        if ctx.group is None:
            dbeta, dgamma = bn_bwd_reduce(x2d, dy2d, mean, inv, gamma, beta)
            dx = bn_bwd_dx(x2d, dy2d, mean, inv, gamma, beta, dbeta, dgamma)
            return dx.view(x.shape), dgamma, dbeta, None, None, None, None, None, None
        local = bn_bwd_reduce_sums(x2d, dy2d, mean, inv, gamma, beta)
        total = local.clone()
        dist.all_reduce(total, group=ctx.group)
        dx = bn_bwd_dx(x2d, dy2d, mean, inv, gamma, beta, total[0], total[1], ctx.n)
        return dx.view(x.shape), local[1], local[0], None, None, None, None, None, None


def fused_bn_relu_train(x, gamma, beta, eps: float = 1e-5, running_mean=None,
                        running_var=None, momentum: float = MOMENTUM):
    """Training-mode BN + ReLU: (y, mean, var), as JAX's fused_bn_relu_train."""
    return BNReLUTrain.apply(x, gamma, beta, eps, running_mean, running_var, momentum)[:3]


class FusedBatchNormReLU(nn.Module):
    """BatchNorm2d + ReLU with torch semantics: momentum 0.1 (decay 0.9), eps
    1e-5, float32 weight/bias/statistics, unbiased running variance.

    Train mode: batch statistics through `BNReLUTrain` (K1-K3), and the running
    stats updated in place (not inside `recomputing()`); with `process_group`
    set (`parallel.mesh.sync_batch_norm`), the batch is every rank's rows,
    counted by `bands` on the 'x'/'y' mesh axes (the whole map's pixels).
    Eval mode: relu((x - running_mean) * rsqrt(running_var + eps) * weight +
    bias). The math runs in float32 and the result is cast to `dtype` (or to
    the input's dtype when `dtype` is None).
    """

    process_group = None
    bands = None

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
        n = (self.bands.count(x) if self.bands is not None and self.process_group is not None
             else None)
        y, mean, _, inv = BNReLUTrain.apply(x, self.weight, self.bias, self.eps, *stats,
                                            MOMENTUM, self.process_group, n)
        return y.to(self.dtype or x.dtype), mean, inv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_dtype = self.dtype or x.dtype
        if self.training:
            return self.train_forward(x)[0]
        scale = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.to(torch.float32) - self.running_mean) * scale + self.bias
        return torch.relu(y).to(out_dtype)
