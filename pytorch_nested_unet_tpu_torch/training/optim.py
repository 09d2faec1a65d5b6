"""Optimizers and LR schedules with the JAX package's semantics (counterpart of
training/optim.py).

`build_optimizer` gives SGD or Adam as the JAX package's optax chains compute
them, which are torch's own update rules (reference trains.py:226-248):
weight decay is L2 added to the gradient before the moments; the momentum
buffer starts at the first gradient; Nesterov is g + momentum*buf; Adam's eps
sits outside the square root, with bias correction. `torch.optim.SGD` and
`torch.optim.Adam` do exactly this and run inside.

Two wrappers match optax's: `skip_nonfinite=N` (optax.apply_if_finite) skips
an update whose gradients hold NaN/inf, leaving parameters and optimizer state
untouched, and tolerates up to N such updates in a row before letting one
through; `accum_steps=K` (optax.MultiSteps) averages the gradients of K calls
and updates on every K-th. The finiteness test reads one flag from the device
per update, so it costs a host sync when it is on.

Under a data mesh (`mesh`, set by `parallel.mesh.shard_train_step`) the
gradients are averaged across ranks once per update, after the K micro-batches
are accumulated and before the finiteness test, which therefore reads the
same averaged gradients on every rank, so every rank skips together. The
all-reduce runs over the batch group (the whole world off a 'model' axis)
and divides by the 'data' size (`parallel.mesh.all_reduce_mean_`): under the
'x'/'y' axes each rank of a data row holds its band's share of the gradient
of the same loss, so the bands' shares are summed and the data rows'
gradients averaged.

Under a 'model' axis (`shard`, from `parallel.mesh.shard_train_step`) the
inner torch optimizer steps this rank's slice of each sharded weight
(`TensorParallel.shards`) in place of the weight, so its momentum or Adam
moments are slices too: the whole gradients are averaged over the batch
group and then taken from the 'model' peer at coordinate 0, so they are
bitwise equal on every peer; the finiteness test reads them whole
(every rank skips together), and each slice takes its rows of its weight's
gradient. The update is elementwise, so the slices are the rows of the
update the unsharded optimizer makes. The `accum_steps` accumulator stays
whole (the JAX package shards MultiSteps' accumulator with the weights;
`param_shaped_leaves` counts it as the JAX package does). `state_dict()`
gives the whole layout (the slices' state gathered over the 'model' peers:
a collective), which restores under any mesh; `state_dict(full=False)` this
rank's own, for the sharded checkpoints.

`LRSchedule` is the host-side per-epoch controller of the reference's four
schedulers.
"""

import math
from typing import Iterable, Optional, Sequence

import torch

from ..parallel.mesh import all_reduce_mean_


class Optimizer:
    """A torch optimizer behind the optax wrappers' semantics.

    Call `zero_grad()`, backward, then `step()`, as with a torch optimizer.
    """

    def __init__(self, params: Iterable[torch.nn.Parameter], optimizer: str = "SGD",
                 lr: float = 1e-3, momentum: float = 0.9, weight_decay: float = 1e-4,
                 nesterov: bool = False, skip_nonfinite: int = 0, accum_steps: int = 1):
        self.params = [p for p in params if p.requires_grad]
        if optimizer == "Adam":
            self.inner = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999),
                                          eps=1e-8, weight_decay=weight_decay)
        elif optimizer == "SGD":
            self.inner = torch.optim.SGD(self.params, lr=lr, momentum=momentum,
                                         weight_decay=weight_decay,
                                         nesterov=bool(nesterov and momentum))
        else:
            raise ValueError(f"unknown optimizer {optimizer!r} (Adam|SGD)")
        self.skip_nonfinite = int(skip_nonfinite or 0)
        self.accum_steps = max(int(accum_steps or 1), 1)
        self.notfinite_run = 0       # consecutive non-finite updates
        self.total_notfinite = 0     # all skipped updates since the start
        self._acc = None
        self._mini_step = 0
        self.mesh = None  # a parallel.mesh.Mesh: gradients averaged across its ranks
        self.tp = None  # a parallel.mesh.TensorParallel: the slices stepped instead
        self.targets = self.params  # what the inner optimizer steps, one per parameter

    @property
    def param_groups(self):
        return self.inner.param_groups

    def param_shaped_leaves(self) -> int:
        """Leaves of the JAX package's optimizer state per parameter that
        have its shape: SGD's momentum (none at momentum 0), Adam's two
        moments, MultiSteps' accumulator."""
        if isinstance(self.inner, torch.optim.Adam):
            n = 2
        else:
            n = int(self.inner.defaults["momentum"] != 0)
        return n + int(self.accum_steps > 1)

    def shard(self, tp):
        """Step `tp`'s slices in place of the weights they are rows of, the
        state kept so far cut to them (`tp`: parallel.mesh.TensorParallel)."""
        state = self.inner.state_dict()
        self.tp = tp
        self.targets = [tp.shards.get(p, p) for p in self.params]
        self.inner = type(self.inner)(self.targets, **self.inner.defaults)
        self.inner.load_state_dict(self._local(state))

    def _local(self, state):
        """A whole-layout inner state dict cut to this rank's slices: each
        per-parameter state tensor of a sharded parameter's shape (Adam's
        scalar step stays)."""
        if self.tp is None:
            return state
        out = dict(state, state={})
        for i, st in state["state"].items():
            p = self.params[i]
            out["state"][i] = {k: self.tp.rows(v, self.tp.dims[p]).clone()
                               if p in self.tp.shards and torch.is_tensor(v)
                               and v.shape == p.shape else v for k, v in st.items()}
        return out

    def layout(self) -> dict:
        """What fixes the structure of the state: the update rule and which
        wrappers are on (optax's chain; resuming across a change raises)."""
        return {"optimizer": type(self.inner).__name__,
                "skip_nonfinite": bool(self.skip_nonfinite),
                "accum_steps": self.accum_steps > 1}

    def state_dict(self, full: bool = True) -> dict:
        """The state; `full`: in the whole layout (under a 'model' axis the
        slices' state gathered over the peers, which every peer must call),
        else with this rank's slices as they are."""
        inner = self.inner.state_dict()
        if full and self.tp is not None:
            inner = self._whole(inner)
        return {"layout": self.layout(), "inner": inner,
                "sharded": not full and self.tp is not None,
                "notfinite_run": self.notfinite_run, "total_notfinite": self.total_notfinite,
                "acc": self._acc, "mini_step": self._mini_step}

    def _whole(self, state):
        """An inner state dict of slices in the whole layout: one all-gather
        of every sliced state tensor, in the parameters' order."""
        sliced = [(i, k) for i, st in sorted(state["state"].items()) for k, v in st.items()
                  if self.params[i] in self.tp.shards and torch.is_tensor(v) and v.dim()
                  and v.shape == self.targets[i].shape]
        wholes = self.tp.all_gather([state["state"][i][k] for i, k in sliced],
                                    [self.tp.dims[self.params[i]] for i, _ in sliced])
        out = dict(state, state={i: dict(st) for i, st in state["state"].items()})
        for (i, k), v in zip(sliced, wholes):
            out["state"][i][k] = v
        return out

    def load_state_dict(self, state: dict):
        """Restore a state_dict() of an optimizer with the same layout; the
        hyperparameters stay this optimizer's (the JAX package rebuilds its
        chain from the flags and restores only its state). A whole-layout
        state goes onto this optimizer's 'model' axis, if it has one, as
        each rank's slices; a sharded one (`state_dict(full=False)`) must
        have been cut for this rank's slices."""
        if state["layout"] != self.layout():
            raise ValueError(f"optimizer state layout {state['layout']} differs from this "
                             f"optimizer's {self.layout()}")
        hyper = [{k: v for k, v in g.items() if k != "params"} for g in self.inner.param_groups]
        self.inner.load_state_dict(state["inner"] if state.get("sharded")
                                   else self._local(state["inner"]))
        for group, h in zip(self.inner.param_groups, hyper):
            group.update(h)
        self.notfinite_run = int(state["notfinite_run"])
        self.total_notfinite = int(state["total_notfinite"])
        self._acc = (None if state["acc"] is None
                     else [a.to(p.device) for a, p in zip(state["acc"], self.params)])
        self._mini_step = int(state["mini_step"])

    def zero_grad(self):
        for p in self.params:
            p.grad = None
        self.inner.zero_grad(set_to_none=True)

    def _grads(self):
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self):
        grads = self._grads()
        if self.accum_steps > 1:
            # running mean of the K micro-batch gradients (optax.MultiSteps)
            if self._acc is None:
                self._acc = [torch.zeros_like(g) for g in grads]
            n = self._mini_step
            for a, g in zip(self._acc, grads):
                a.add_((g - a) / (n + 1))
            self._mini_step = (n + 1) % self.accum_steps
            if self._mini_step != 0:
                return
            grads = self._acc
            self._acc = None
        if self.mesh is not None:
            all_reduce_mean_(grads, self.mesh)
        if self.skip_nonfinite:
            finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
            self.notfinite_run = 0 if finite else self.notfinite_run + 1
            if not finite:
                self.total_notfinite += 1
                if self.notfinite_run <= self.skip_nonfinite:
                    return
        for p, t, g in zip(self.params, self.targets, grads):
            t.grad = g if t is p else self.tp.rows(g, self.tp.dims[p])
        self.inner.step()


def build_optimizer(params, optimizer: str = "SGD", lr: float = 1e-3,
                    momentum: float = 0.9, weight_decay: float = 1e-4,
                    nesterov: bool = False, skip_nonfinite: int = 0,
                    accum_steps: int = 1) -> Optimizer:
    """The JAX package's `build_optimizer` over `params` (see module docstring)."""
    return Optimizer(params, optimizer, lr, momentum, weight_decay, nesterov,
                     skip_nonfinite, accum_steps)


def set_learning_rate(opt, lr: float):
    for group in opt.param_groups:
        group["lr"] = float(lr)


def get_learning_rate(opt) -> float:
    return float(opt.param_groups[0]["lr"])


def nonfinite_count(opt) -> Optional[int]:
    """Skipped (non-finite) updates since the start, or None when
    `skip_nonfinite` is off."""
    return opt.total_notfinite if opt.skip_nonfinite else None


def state_bytes(module: torch.nn.Module, opt: Optimizer) -> int:
    """Bytes this rank holds of `module`'s parameters and `opt`'s state (a
    JAX TrainState's params and opt_state): every distinct storage among the
    parameters (a weight freed on the 'model' axis holds none), the slices
    `opt` steps, their per-parameter state and the gradient accumulator."""
    tensors = [*module.parameters(), *opt.targets, *(opt._acc or ()),
               *(v for st in opt.inner.state.values() for v in st.values() if torch.is_tensor(v))]
    storages = {}
    for t in tensors:
        st = t.untyped_storage()
        if st.nbytes():
            storages[(st.data_ptr(), t.device)] = st.nbytes()
    return sum(storages.values())


def params_all_finite(params) -> bool:
    """One device reduction over every parameter, read once."""
    params = list(params)
    return bool(torch.stack([torch.isfinite(p).all() for p in params]).all())


class LRSchedule:
    """Host-side per-epoch LR controller covering the reference's four schedulers.

    Call `lr = sched.epoch_lr(epoch)` before the epoch; for ReduceLROnPlateau
    call `sched.plateau_step(val_loss)` after validation.
    """

    def __init__(self, scheduler: str, base_lr: float, epochs: int,
                 min_lr: float = 1e-5, factor: float = 0.1, patience: int = 2,
                 milestones: Optional[Sequence[int]] = None, gamma: float = 2 / 3):
        if scheduler not in ("CosineAnnealingLR", "ReduceLROnPlateau",
                             "MultiStepLR", "ConstantLR"):
            raise ValueError(f"unknown scheduler {scheduler!r}")
        self.kind = scheduler
        self.base_lr = base_lr
        self.epochs = epochs
        self.min_lr = min_lr
        self.factor = factor
        self.patience = patience
        self.milestones = sorted(milestones or [1, 2])
        self.gamma = gamma
        self._lr = base_lr
        self._best = math.inf
        self._bad_epochs = 0

    def epoch_lr(self, epoch: int) -> float:
        if self.kind == "CosineAnnealingLR":
            # torch: eta_min + (base - eta_min) * (1 + cos(pi * e / T_max)) / 2
            return self.min_lr + (self.base_lr - self.min_lr) * (
                1 + math.cos(math.pi * epoch / self.epochs)) / 2
        if self.kind == "MultiStepLR":
            k = sum(1 for m in self.milestones if epoch >= m)
            return self.base_lr * (self.gamma ** k)
        if self.kind == "ReduceLROnPlateau":
            return self._lr
        return self.base_lr  # ConstantLR

    def plateau_step(self, val_loss: float):
        """torch ReduceLROnPlateau (mode=min, threshold 1e-4 rel)."""
        if self.kind != "ReduceLROnPlateau":
            return
        if val_loss < self._best * (1 - 1e-4):
            self._best = val_loss
            self._bad_epochs = 0
        else:
            self._bad_epochs += 1
            if self._bad_epochs > self.patience:
                self._lr = max(self._lr * self.factor, self.min_lr)
                self._bad_epochs = 0
