"""Optimizer registry: the reference's in-HBM optimizers in torch ops.

Port of ``deepspeed_tpu/ops/optimizers.py``, whose names map to optax
transformations (optax 0.2.6). Each class here repeats optax's arithmetic
in torch ops, one parameter at a time so that no temporary is larger than
the largest parameter; its state tensors are the shape of what it updates
(a ZeRO block where the engine shards the moments), ``state_dict()`` and
``load_state_dict()`` carry them with the update count, and the learning
rate is ``lr(t)`` with ``t`` the count of applied updates (a step the
engine skips on overflow never calls ``step``):

- ``adam``, ``fusedadam``, ``adamw``, ``cpuadam``, ``deepspeedcpuadam``,
  ``cpu_adam`` -> ``Adam``: ``scale_by_adam`` (``mu = (1-b1) g + b1 mu``,
  ``nu = (1-b2) g^2 + b2 nu``, bias-corrected by ``1 - b^t``, then
  ``mu_hat / (sqrt(nu_hat) + eps)``), ``add_decayed_weights`` (``+ wd p``;
  with ``adam_w_mode=False`` L2, added to the gradient first), ``* -lr``.
  ``adamw`` decays 0.01 by default, the others 0.
- ``lamb``, ``fusedlamb`` -> ``Lamb``: ``scale_by_adam`` (eps 1e-6), the
  decay, then ``scale_by_trust_ratio``: the update of each whole leaf
  times ``|p| / |u|`` (1 where either norm is 0), then ``* -lr``. Where a
  rank holds blocks of a leaf, ``reduce_leaf_sums`` (set by the engine)
  sums the blocks' squares over the ranks that cut it.
- ``lion``, ``fusedlion``, ``cpulion`` -> ``Lion``: ``u = sign((1-b1) g +
  b1 m)``, then ``m = (1-b2) g + b2 m``, ``+ wd p``, ``* -lr`` (betas
  0.9 / 0.99).
- ``adagrad``, ``cpuadagrad``, ``cpu_adagrad`` -> ``Adagrad``: ``s +=
  g^2`` from 0.1, ``u = g rsqrt(s + eps)`` where ``s > 0`` else 0 (eps
  1e-10, inside the root), ``* -lr``.
- ``sgd``, ``momentum`` -> ``SGD``: the trace ``t = g + mu t``; the update
  ``g + mu t`` with ``nesterov``, else ``t``; ``* -lr``.
- ``rmsprop`` -> ``RMSprop``: ``nu = (1-a) g^2 + a nu`` with ``a`` the
  config's ``alpha`` (0.99), ``u = g rsqrt(nu + eps)`` (eps inside the
  root), ``* -lr``, then the trace ``t = u + momentum t`` over the scaled
  update, as optax chains it.

The 1-bit names (``onebitadam``, ``zerooneadam``, ``onebitlamb``) raise
``NotImplementedError``: they come with ``ops/onebit.py`` and
``comm/compressed.py`` (ROADMAP Queue 1 item 7).
"""

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

ScheduleOrFloat = Union[float, Callable[[int], float]]

ADAM_NAMES = ("adam", "fusedadam", "adamw", "deepspeedcpuadam", "cpuadam",
              "cpu_adam")
LAMB_NAMES = ("lamb", "fusedlamb")
LION_NAMES = ("lion", "fusedlion", "cpulion")
ADAGRAD_NAMES = ("adagrad", "cpuadagrad", "cpu_adagrad")
SGD_NAMES = ("sgd", "momentum")
RMSPROP_NAMES = ("rmsprop",)
ONEBIT_NAMES = ("onebitadam", "zerooneadam", "onebitlamb")


class Optimizer:
    """The shared part: the schedule, the count of applied updates and the
    per-parameter state lists named by ``STATE`` (each starts at
    ``INIT.get(name, 0.0)``)."""

    STATE: Tuple[str, ...] = ()
    INIT: Dict[str, float] = {}

    def __init__(self, lr: ScheduleOrFloat):
        self.lr = lr
        self.count = 0                       # applied updates
        for name in self.STATE:
            setattr(self, name, [])

    def init(self, params: Sequence[torch.Tensor]) -> None:
        self.count = 0
        for name in self.STATE:
            v = self.INIT.get(name, 0.0)
            setattr(self, name, [torch.full_like(p, v) if v
                                 else torch.zeros_like(p) for p in params])

    def current_lr(self) -> float:
        return float(self.lr(self.count)) if callable(self.lr) else float(self.lr)

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor],
             grads: Sequence[torch.Tensor]) -> None:
        """One update in place. ``grads`` may be overwritten."""
        self._update(params, grads, self.current_lr(), self.count + 1)
        self.count += 1

    def _update(self, params, grads, lr: float, t: int) -> None:
        raise NotImplementedError

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count,
                **{name: list(getattr(self, name)) for name in self.STATE}}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Copy a ``state_dict()`` into the state of ``init``'s shapes."""
        for name in self.STATE:
            mine, theirs = getattr(self, name), sd[name]
            if len(mine) != len(theirs):
                raise ValueError(f"{name}: {len(theirs)} tensors, the "
                                 f"optimizer holds {len(mine)}")
            for a, b in zip(mine, theirs):
                a.copy_(b)
        self.count = int(sd["count"])

    def state_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for name in self.STATE for t in getattr(self, name))


class Adam(Optimizer):
    """optax's Adam/AdamW update on a list of fp32 master tensors."""

    STATE = ("mu", "nu")

    def __init__(self, lr: ScheduleOrFloat, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 decoupled: bool = True):
        super().__init__(lr)
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        self.decoupled = decoupled

    def _moments(self, p, g, mu, nu):
        if self.weight_decay and not self.decoupled:
            g = g.add(p, alpha=self.weight_decay)    # L2: decay joins g
        mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
        nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)

    def _direction(self, p, mu, nu, bc1, bc2):
        """The bias-corrected Adam direction plus the decoupled decay."""
        update = (mu / bc1).div_((nu / bc2).sqrt_().add_(self.eps))
        if self.weight_decay and self.decoupled:
            update.add_(p, alpha=self.weight_decay)
        return update

    def _update(self, params, grads, lr, t):
        bc1, bc2 = 1.0 - self.b1 ** t, 1.0 - self.b2 ** t
        for p, g, mu, nu in zip(params, grads, self.mu, self.nu):
            self._moments(p, g, mu, nu)
            p.add_(self._direction(p, mu, nu, bc1, bc2), alpha=-lr)


class Lamb(Adam):
    """optax's LAMB: the Adam direction (decoupled decay) scaled per whole
    leaf by the trust ratio ``|p| / |u|``. Two passes over the leaves:
    the moments and each leaf's two squared norms first, reduced over the
    ranks in one call of ``reduce_leaf_sums`` (a list of ``[2]`` tensors,
    one a leaf, to the same list summed over the ranks holding that leaf's
    blocks; None at one rank), then the update, its direction computed
    again from the moments by the same ops."""

    def __init__(self, lr: ScheduleOrFloat, betas=(0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.0):
        super().__init__(lr, betas, eps, weight_decay, decoupled=True)
        self.reduce_leaf_sums: Optional[
            Callable[[List[torch.Tensor]], List[torch.Tensor]]] = None

    def _update(self, params, grads, lr, t):
        bc1, bc2 = 1.0 - self.b1 ** t, 1.0 - self.b2 ** t
        sums = []
        for p, g, mu, nu in zip(params, grads, self.mu, self.nu):
            self._moments(p, g, mu, nu)
            u = self._direction(p, mu, nu, bc1, bc2)
            sums.append(torch.stack([p.square().sum(), u.square().sum()]))
            del u
        if self.reduce_leaf_sums is not None:
            sums = self.reduce_leaf_sums(sums)
        for p, mu, nu, s in zip(params, self.mu, self.nu, sums):
            norms = s.sqrt()
            ratio = torch.where((norms[0] == 0) | (norms[1] == 0),
                                torch.ones_like(norms[0]),
                                norms[0] / norms[1])
            u = self._direction(p, mu, nu, bc1, bc2).mul_(ratio)
            p.add_(u, alpha=-lr)


class Lion(Optimizer):
    """optax's Lion: the sign of the interpolated gradient, decayed."""

    STATE = ("mu",)

    def __init__(self, lr: ScheduleOrFloat, betas=(0.9, 0.99),
                 weight_decay: float = 0.0):
        super().__init__(lr)
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.weight_decay = float(weight_decay)

    def _update(self, params, grads, lr, t):
        for p, g, mu in zip(params, grads, self.mu):
            u = (g * (1.0 - self.b1)).add_(mu, alpha=self.b1).sign_()
            mu.mul_(self.b2).add_(g, alpha=1.0 - self.b2)
            if self.weight_decay:
                u.add_(p, alpha=self.weight_decay)
            p.add_(u, alpha=-lr)


class Adagrad(Optimizer):
    """optax's Adagrad (``scale_by_rss``): the accumulator starts at 0.1."""

    STATE = ("sum_of_squares",)
    INIT = {"sum_of_squares": 0.1}

    def __init__(self, lr: ScheduleOrFloat, eps: float = 1e-10):
        super().__init__(lr)
        self.eps = float(eps)

    def _update(self, params, grads, lr, t):
        for p, g, s in zip(params, grads, self.sum_of_squares):
            s.addcmul_(g, g)
            scale = torch.where(s > 0, (s + self.eps).rsqrt_(),
                                torch.zeros_like(s))
            p.add_(scale.mul_(g), alpha=-lr)


class SGD(Optimizer):
    """optax's SGD: the momentum trace (kept at momentum 0 too, as optax
    keeps it), Nesterov's look-ahead on request."""

    STATE = ("trace",)

    def __init__(self, lr: ScheduleOrFloat, momentum: float = 0.0,
                 nesterov: bool = False):
        super().__init__(lr)
        self.momentum = float(momentum)
        self.nesterov = bool(nesterov)

    def _update(self, params, grads, lr, t):
        for p, g, tr in zip(params, grads, self.trace):
            tr.mul_(self.momentum).add_(g)
            u = (tr * self.momentum).add_(g) if self.nesterov else tr
            p.add_(u, alpha=-lr)


class RMSprop(Optimizer):
    """optax's RMSprop (not centred): the squared-gradient average, eps
    inside the root, the learning rate, then the momentum trace of the
    scaled update."""

    STATE = ("nu", "trace")

    def __init__(self, lr: ScheduleOrFloat, decay: float = 0.99,
                 eps: float = 1e-8, momentum: float = 0.0):
        super().__init__(lr)
        self.decay = float(decay)
        self.eps = float(eps)
        self.momentum = float(momentum)

    def _update(self, params, grads, lr, t):
        for p, g, nu, tr in zip(params, grads, self.nu, self.trace):
            nu.mul_(self.decay).addcmul_(g, g, value=1.0 - self.decay)
            u = (nu + self.eps).rsqrt_().mul_(g).mul_(-lr)
            tr.mul_(self.momentum).add_(u)
            p.add_(tr)


def build_optimizer(opt_type: str, opt_params: Dict[str, Any],
                    lr_schedule: Optional[Callable[[int], float]] = None
                    ) -> Optimizer:
    """Map a reference optimizer config onto its class here, with the JAX
    package's defaults. The learning rate is ``lr_schedule`` if given (the
    engine threads the config scheduler here), else the static ``lr`` from
    the optimizer params."""
    name = opt_type.lower()
    lr: ScheduleOrFloat = lr_schedule if lr_schedule is not None \
        else opt_params.get("lr", 1e-3)
    wd = opt_params.get("weight_decay", 0.0)
    if name in ("adam", "fusedadam"):
        return Adam(lr, opt_params.get("betas", (0.9, 0.999)),
                    opt_params.get("eps", 1e-8), wd,
                    decoupled=opt_params.get("adam_w_mode", True))
    if name in ADAM_NAMES:
        return Adam(lr, opt_params.get("betas", (0.9, 0.999)),
                    opt_params.get("eps", 1e-8), opt_params.get(
                        "weight_decay", 0.01 if name == "adamw" else 0.0),
                    decoupled=True)
    if name in LAMB_NAMES:
        return Lamb(lr, opt_params.get("betas", (0.9, 0.999)),
                    opt_params.get("eps", 1e-6), wd)
    if name in LION_NAMES:
        return Lion(lr, opt_params.get("betas", (0.9, 0.99)), wd)
    if name in ADAGRAD_NAMES:
        return Adagrad(lr, opt_params.get("eps", 1e-10))
    if name in SGD_NAMES:
        return SGD(lr, opt_params.get("momentum", 0.0),
                   opt_params.get("nesterov", False))
    if name in RMSPROP_NAMES:
        return RMSprop(lr, opt_params.get("alpha", 0.99),
                       opt_params.get("eps", 1e-8),
                       opt_params.get("momentum", 0.0))
    if name in ONEBIT_NAMES:
        raise NotImplementedError(
            f"optimizer '{opt_type}' is not ported yet (ROADMAP Queue 1 item "
            "7: the 1-bit optimizers come with ops/onebit.py and "
            "comm/compressed.py)")
    raise ValueError(f"unknown optimizer type '{opt_type}'")
