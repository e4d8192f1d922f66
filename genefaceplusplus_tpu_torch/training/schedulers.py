"""The exponential LR schedule and the grouped RAD-NeRF Adam (port of
`exponential_schedule`, `_radnerf_group`, `grad_norms_by_group` and
`make_radnerf_optimizer` in `genefaceplusplus_tpu/training/schedulers.py`),
and `OptaxAdam`, the plain `optax.adam` of the a2m and postnet tasks.

The optimizer is `torch.optim.Adam` (eps 1e-15, betas 0.9 / 0.999) with
one parameter group per label: net x1, grid x10 (the Fourier `B`s), att x5.
Before each step every group's lr is set to schedule(count) * its
multiplier, where count is the number of steps taken so far, as optax's
`scale_by_schedule` does under `multi_transform`. A parameter without a
gradient steps with a zero gradient, as optax's Adam does. Like optax over
JAX's whole variables tree, it also steps a model's floating-point buffers
(the SR's `noise_const`, in flax's `buffers` collection), which it makes
require gradients.

`export_optax` / `load_optax` carry the state in optax's layout, as flax
serialises `make_radnerf_optimizer`'s `multi_transform` state:
{'inner_states': {label: {'inner_state': {'0': {'count', 'mu', 'nu'},
'1': {'count'}}}}} (`scale_by_adam`, then `scale_by_schedule`), where `mu`
and `nu` are the variables tree with every tensor of another label an
empty dict (optax's `MaskedNode`), and every count is the number of steps.
`OptaxAdam`'s layout is `optax.adam`'s chain: {'0': {'count', 'mu',
'nu'}, '1': {}} (`scale_by_adam`, then the constant learning rate's empty
state).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from genefaceplusplus_tpu_torch.utils.convert_jax import export_flax_tree, flax_tree_leaves

GROUP_MULT = {"net": 1.0, "grid": 10.0, "att": 5.0}


def exponential_schedule(lr: float, warmup_updates: int = 0, floor: float = 1e-5,
                         decay_steps: int = 250_000) -> Callable[[int], float]:
    def sched(step) -> float:
        step = float(step)
        out = max(lr * (0.1 ** (step / decay_steps)), floor)
        if warmup_updates > 0 and step <= warmup_updates:
            out = max(lr * min(step / warmup_updates, 1.0), floor)
        return out

    return sched


def _radnerf_group(name: str) -> str:
    """Label of a parameter by its dotted name: grid (Fourier encoders),
    att (the condition attention net) or net."""
    if "position_embedder" in name or "ambient_embedder" in name or "torso_embedder" in name:
        return "grid"
    if "cond_att_net" in name:
        return "att"
    return "net"


def grad_norms_by_group(named_grads: Iterable[Tuple[str, torch.Tensor]],
                        group_fn=_radnerf_group) -> Dict[str, torch.Tensor]:
    """Per-group L2 gradient norms and the total, as a metrics dict."""
    sq: Dict[str, torch.Tensor] = {}
    for name, g in named_grads:
        k = group_fn(name)
        sq[k] = sq.get(k, 0.0) + torch.sum(torch.square(g.float()))
    out = {f"grad_norm/{k}": torch.sqrt(v) for k, v in sq.items()}
    out["grad_norm/total"] = torch.sqrt(sum(sq.values()))
    return out


def _moments(opt: torch.optim.Optimizer, named) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """{name: (exp_avg, exp_avg_sq)} of `opt`'s tensors (zeros before a step)."""
    out = {}
    for name, p in named:
        st = opt.state.get(p, {})
        out[name] = (st.get("exp_avg", torch.zeros_like(p)), st.get("exp_avg_sq", torch.zeros_like(p)))
    return out


def _load_moments(opt: torch.optim.Optimizer, named, mu: Mapping[str, np.ndarray],
                  nu: Mapping[str, np.ndarray], count: int, what: str = ""):
    """Set each named tensor's Adam moments from `mu`/`nu` ({state-dict key:
    array}) and every step to `count`; a tensor without moments of its shape
    raises."""
    for name, p in named:
        if name not in mu or name not in nu or tuple(mu[name].shape) != tuple(p.shape):
            raise KeyError(f"optimizer state: no {what}moments of shape {tuple(p.shape)} for {name!r}")
        opt.state[p] = {"exp_avg": torch.from_numpy(np.array(mu[name], np.float32)).to(p.device),
                        "exp_avg_sq": torch.from_numpy(np.array(nu[name], np.float32)).to(p.device),
                        "step": torch.tensor(float(count), dtype=torch.float32)}


class RADNeRFAdam:
    """Adam over a module's parameters and float buffers in the RAD-NeRF
    groups."""

    def __init__(self, model: torch.nn.Module, lr: float = 5e-4, warmup_updates: int = 0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15):
        self.model = model
        buffers = [(k, b) for k, b in model.named_buffers() if b.is_floating_point()]
        for _, b in buffers:
            b.requires_grad_(True)
        self.named = list(model.named_parameters()) + buffers
        self.params = [p for _, p in self.named]
        groups: Dict[str, list] = {k: [] for k in GROUP_MULT}
        for name, p in self.named:
            groups[_radnerf_group(name)].append(p)
        self.sched = exponential_schedule(lr, warmup_updates)
        self.opt = torch.optim.Adam(
            [{"params": ps, "mult": GROUP_MULT[k], "label": k} for k, ps in groups.items() if ps],
            lr=lr, betas=(b1, b2), eps=eps)
        self.count = 0

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self):
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        lr = self.sched(self.count)
        for g in self.opt.param_groups:
            g["lr"] = lr * g["mult"]
        self.opt.step()
        self.count += 1

    def state_dict(self):
        return {"opt": self.opt.state_dict(), "count": self.count}

    def load_state_dict(self, d):
        self.opt.load_state_dict(d["opt"])
        self.count = int(d["count"])

    def export_optax(self) -> Dict[str, Any]:
        """The state as flax serialises optax's (module docstring)."""
        moments = _moments(self.opt, self.named)
        count = np.asarray(self.count, np.int32)
        out = {}
        for label in GROUP_MULT:
            mu = {n: m[0] if _radnerf_group(n) == label else None for n, m in moments.items()}
            nu = {n: m[1] if _radnerf_group(n) == label else None for n, m in moments.items()}
            out[label] = {"inner_state": {
                "0": {"count": count, "mu": export_flax_tree(self.model, mu),
                      "nu": export_flax_tree(self.model, nu)},
                "1": {"count": count}}}
        return {"inner_states": out}

    def load_optax(self, opt_state: Mapping[str, Any]):
        """Restore moments and the step count from optax's layout; every
        tensor must find its moments under its own label."""
        inners = {label: opt_state["inner_states"][label]["inner_state"] for label in GROUP_MULT}
        counts = {int(c) for inner in inners.values() for c in (inner["0"]["count"], inner["1"]["count"])}
        if len(counts) != 1:
            raise ValueError(f"optimizer state: the groups' step counts differ: {sorted(counts)}")
        self.count = counts.pop()
        for label, inner in inners.items():
            _load_moments(self.opt, [(n, p) for n, p in self.named if _radnerf_group(n) == label],
                          flax_tree_leaves(inner["0"]["mu"], self.model),
                          flax_tree_leaves(inner["0"]["nu"], self.model), self.count, f"{label} ")


class OptaxAdam:
    """`optax.adam(lr, b1, b2, eps)` over a module's parameters (not its
    buffers: BatchNorm's running statistics are flax's `batch_stats`,
    which the optimizer does not see), as `torch.optim.Adam`.

    `collection` says which tree JAX's `tx.init` saw, so the moments nest as
    optax's do: "params" for a task that optimises `variables['params']`
    (the a2m: `mu` is the bare param tree), None for one whose state holds
    the whole `{'params': ...}` dict (the postnet: `mu` is `{'params':
    ...}`)."""

    def __init__(self, model: torch.nn.Module, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, collection: Optional[str] = "params"):
        self.model = model
        self.collection = collection
        self.named = list(model.named_parameters())
        self.opt = torch.optim.Adam([p for _, p in self.named], lr=lr, betas=(b1, b2), eps=eps)
        self.count = 0

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self):
        for _, p in self.named:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.opt.step()
        self.count += 1

    def _tree(self, values) -> Dict[str, Any]:
        tree = export_flax_tree(self.model, values)
        return tree[self.collection] if self.collection else tree

    def export_optax(self) -> Dict[str, Any]:
        """The state as flax serialises `optax.adam`'s (module docstring)."""
        moments = _moments(self.opt, self.named)
        return {"0": {"count": np.asarray(self.count, np.int32),
                      "mu": self._tree({n: m[0] for n, m in moments.items()}),
                      "nu": self._tree({n: m[1] for n, m in moments.items()})},
                "1": {}}

    def load_optax(self, opt_state: Mapping[str, Any]):
        """Restore the moments and the step count from optax's layout; every
        parameter must find its moments."""
        inner = opt_state["0"]
        self.count = int(inner["count"])
        _load_moments(self.opt, self.named, flax_tree_leaves(inner["mu"], self.model),
                      flax_tree_leaves(inner["nu"], self.model), self.count)


def make_radnerf_optimizer(lr: float = 5e-4, warmup_updates: int = 0, b1: float = 0.9,
                           b2: float = 0.999, eps: float = 1e-15) -> Callable[[torch.nn.Module], RADNeRFAdam]:
    """Adam with RAD-NeRF param groups (grid x10, att x5, rest x1), as a
    function of the module it steps: `make_radnerf_optimizer(lr)(model)`."""
    return functools.partial(RADNeRFAdam, lr=lr, warmup_updates=warmup_updates, b1=b1, b2=b2, eps=eps)
