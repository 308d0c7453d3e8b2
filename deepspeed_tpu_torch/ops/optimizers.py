"""Optimizer registry, cut to the Adam family.

Port of ``deepspeed_tpu/ops/optimizers.py``. The names that map to
``optax.adam``/``optax.adamw`` there (``adam``, ``fusedadam``, ``adamw``,
``cpuadam``, ``deepspeedcpuadam``, ``cpu_adam``) build ``Adam``, which
repeats optax's update in torch ops, one parameter at a time so that no
temporary is larger than the largest parameter:

- ``scale_by_adam``: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``,
  bias-corrected by ``1 - b^t`` with ``t`` the count of applied updates,
  then ``mu_hat / (sqrt(nu_hat) + eps)`` (eps outside the root);
- ``add_decayed_weights``: ``+ wd * param`` on every parameter, no mask
  (decoupled AdamW); with ``adam_w_mode=False`` the decay is L2, added to
  the gradients before Adam instead;
- ``scale_by_learning_rate``: ``* -lr(t)``, then ``param += update``.

``adamw`` decays 0.01 by default, the others 0. A step the engine skips
(overflow) never calls ``step``, so it advances neither the count nor the
schedule. The other optimizer names of the reference raise
``NotImplementedError`` (ROADMAP Queue 1).
"""

from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch

ScheduleOrFloat = Union[float, Callable[[int], float]]

ADAM_NAMES = ("adam", "fusedadam", "adamw", "deepspeedcpuadam", "cpuadam",
              "cpu_adam")
NOT_PORTED = ("lamb", "fusedlamb", "lion", "fusedlion", "cpulion", "adagrad",
              "cpuadagrad", "cpu_adagrad", "sgd", "momentum", "rmsprop",
              "onebitadam", "zerooneadam", "onebitlamb")


class Adam:
    """optax's Adam/AdamW update on a list of fp32 master tensors."""

    def __init__(self, lr: ScheduleOrFloat, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 decoupled: bool = True):
        self.lr = lr
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        self.decoupled = decoupled
        self.count = 0                       # applied updates
        self.mu: List[torch.Tensor] = []
        self.nu: List[torch.Tensor] = []

    def init(self, params: Sequence[torch.Tensor]) -> None:
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    def current_lr(self) -> float:
        return float(self.lr(self.count)) if callable(self.lr) else float(self.lr)

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor],
             grads: Sequence[torch.Tensor]) -> None:
        """One update in place. ``grads`` may be overwritten."""
        lr = self.current_lr()
        t = self.count + 1
        bc1, bc2 = 1.0 - self.b1 ** t, 1.0 - self.b2 ** t
        wd = self.weight_decay
        for p, g, mu, nu in zip(params, grads, self.mu, self.nu):
            if wd and not self.decoupled:
                g = g.add(p, alpha=wd)       # L2: decay joins the gradient
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            update = (mu / bc1).div_((nu / bc2).sqrt_().add_(self.eps))
            if wd and self.decoupled:
                update.add_(p, alpha=wd)
            p.add_(update, alpha=-lr)
        self.count = t


def build_optimizer(opt_type: str, opt_params: Dict[str, Any],
                    lr_schedule: Optional[Callable[[int], float]] = None
                    ) -> Adam:
    """Map a reference optimizer config onto ``Adam``. The learning rate is
    ``lr_schedule`` if given (the engine threads the config scheduler
    here), else the static ``lr`` from the optimizer params."""
    name = opt_type.lower()
    lr: ScheduleOrFloat = lr_schedule if lr_schedule is not None \
        else opt_params.get("lr", 1e-3)
    betas = opt_params.get("betas", (0.9, 0.999))
    eps = opt_params.get("eps", 1e-8)
    if name in ("adam", "fusedadam"):
        return Adam(lr, betas, eps, opt_params.get("weight_decay", 0.0),
                    decoupled=opt_params.get("adam_w_mode", True))
    if name in ADAM_NAMES:
        return Adam(lr, betas, eps, opt_params.get(
            "weight_decay", 0.01 if name == "adamw" else 0.0), decoupled=True)
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"optimizer '{opt_type}' is not ported yet (ROADMAP Queue 1: "
            "the optimizers other than Adam); use Adam or AdamW")
    raise ValueError(f"unknown optimizer type '{opt_type}'")
