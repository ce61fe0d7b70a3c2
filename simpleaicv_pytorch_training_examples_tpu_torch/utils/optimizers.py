"""Optimizer factory with per-parameter rules: AdamW, SGD and Muon.

Counterpart of the JAX package's ``utils/optimizers.py``. The config's
``optimizer = (name, params_dict)`` selects the update rule, with

- ``global_weight_decay=False`` zeroing weight decay on 1-D parameters and on
  any parameter whose name contains an entry of
  ``no_weight_decay_layer_name_list``;
- ``sub_layer_weight_decay`` / ``sub_layer_lr`` overrides by name fragment;
- ViT layer-wise lr decay through ``lr_layer_decay``,
  ``lr_layer_decay_block`` (number of transformer blocks) and ``block_name``
  (the prefix of a block's name, ``"blocks."`` here); the stem
  (``pos_embed``, ``cls_token``, ``patch_embed``) gets the deepest decay and
  the head 1.0;
- Muon for every parameter of 2 or more dims whose name contains none of
  ``_STEM_LAYER_NAMES`` and ``exclude_muon_layer_name_list``, AdamW for the
  rest, with one lr and one decoupled weight decay for all (the rules above
  do not apply to Muon, as in the JAX package).

Names are the model's ``named_parameters()`` names.

The update is the JAX package's: fp32 state, ``lr_t = schedule(step) *
leaf_lr * layer_scale`` with the optimizer's own step count, AdamW's weight
decay decoupled and scaled by the live lr, SGD's coupled as in
``torch.optim.SGD``. Everything runs on the parameters' device without a
host synchronisation: the schedule is a table of multipliers indexed by the
step tensor, and ``update(grads, finite)`` takes a 0-dim bool tensor; where
it is False the step leaves parameters, moments and the step count bit for
bit as they were (the coefficients turn into 1 and 0 and the gradients into
zeros), which is how a non-finite step is skipped.
"""

import re

import torch

from .muon import from_muon_matrix, muon_matrix, newton_schulz5
from .schedules import build_schedule

SUPPORTED_OPTIMIZERS = ("SGD", "AdamW", "Muon")

_STEM_LAYER_NAMES = ("pos_embed", "cls_token", "patch_embed")


def compute_wd_and_lr(named_params, optimizer_parameters):
    """Per-parameter (names, weight_decay, lr, layer lr scale)."""
    lr = optimizer_parameters["lr"]
    weight_decay = optimizer_parameters.get("weight_decay", 0.0)
    global_wd = optimizer_parameters.get("global_weight_decay", True)
    no_wd_names = optimizer_parameters.get("no_weight_decay_layer_name_list",
                                           []) or []
    sub_wd = optimizer_parameters.get("sub_layer_weight_decay", None)
    sub_lr = optimizer_parameters.get("sub_layer_lr", None)

    use_layer_decay = all(
        k in optimizer_parameters
        for k in ("lr_layer_decay", "lr_layer_decay_block", "block_name"))
    if use_layer_decay:
        layer_decay = optimizer_parameters["lr_layer_decay"]
        n_blocks = optimizer_parameters["lr_layer_decay_block"]
        if not isinstance(n_blocks, int):
            n_blocks = len(n_blocks)
        num_layers = n_blocks + 1
        # scales[i] = decay**(num_layers - i); block i uses scales[i + 1],
        # the stem scales[0], everything else 1.0
        lr_layer_scales = [layer_decay ** (num_layers - i)
                           for i in range(num_layers + 1)]
        block_idx_re = re.compile(
            re.escape(optimizer_parameters["block_name"]) + r"(\d+)")

    names, wds, lrs, scales = [], [], [], []
    for name, param in named_params:
        if not global_wd and (param.ndim == 1
                              or any(n in name for n in no_wd_names)):
            wd = 0.0
        else:
            wd = weight_decay
            if not global_wd and isinstance(sub_wd, dict):
                for fragment, v in sub_wd.items():
                    if fragment in name:
                        wd = v
                        break
        leaf_lr = lr
        if isinstance(sub_lr, dict):
            for fragment, v in sub_lr.items():
                if fragment in name:
                    leaf_lr = v
                    break
        scale = 1.0
        if use_layer_decay:
            m = block_idx_re.search(name)
            if m is not None:
                scale = lr_layer_scales[int(m.group(1)) + 1]
            elif any(s in name for s in _STEM_LAYER_NAMES):
                scale = lr_layer_scales[0]
        names.append(name)
        wds.append(wd)
        lrs.append(leaf_lr)
        scales.append(scale)
    return names, wds, lrs, scales


def _group_report(names, wds, lrs, scales):
    groups = {}
    for n, w, l, s in zip(names, wds, lrs, scales):
        groups.setdefault((w, l, s), []).append(n)
    return [{"name": v, "weight_decay": k[0], "lr": k[1], "lr_scale": k[2]}
            for k, v in groups.items()]


class Optimizer:
    """AdamW, SGD or Muon over a model's parameters, updated in place.

    State: ``step`` (0-dim int64 on the device) and fp32 moment tensors per
    parameter: ``mu``/``nu`` (AdamW), ``momentum_buf`` (SGD), or
    ``muon_buf``, ``mu`` and ``nu`` for every parameter (Muon, as the JAX
    package's state holds them; each parameter moves only the slots of its
    own rule). ``use_muon`` and ``out_first`` (Muon only) give each
    parameter's rule and the layout of its matrix (``utils/muon.py``).
    """

    def __init__(self, name, named_params, multipliers, wds, lrmuls,
                 use_muon=None, out_first=None, **hyper):
        self.name = name
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        device = self.params[0].device
        self.multipliers = torch.tensor(multipliers, dtype=torch.float32,
                                        device=device)
        self.wds = list(wds)
        self.neg_lrmuls = [-m for m in lrmuls]
        self.hyper = hyper
        self.step = torch.zeros((), dtype=torch.int64, device=device)
        slots = {"AdamW": ("mu", "nu"), "SGD": ("momentum_buf",),
                 "Muon": ("muon_buf", "mu", "nu")}[name]
        self.moments = {slot: [torch.zeros_like(p, dtype=torch.float32)
                               for p in self.params] for slot in slots}
        if name == "Muon":
            self.muon_index = [i for i, u in enumerate(use_muon) if u]
            self.adamw_index = [i for i, u in enumerate(use_muon) if not u]
            self.out_first = list(out_first)

    @torch.no_grad()
    def update(self, grads, finite):
        """One step over ``grads`` (one per parameter); a no-op where the
        0-dim bool tensor ``finite`` is False."""
        on = finite.to(torch.float32)
        grads = [torch.where(finite, g, 0.0) for g in grads]
        index = self.step.clamp(max=self.multipliers.numel() - 1)
        lr_gate = self.multipliers[index] * on
        params = self.params

        if self.name == "AdamW":
            delta = self._adamw_delta(range(len(params)), grads, finite, on)
        elif self.name == "Muon":
            delta = [None] * len(params)
            for i, d in zip(self.adamw_index, self._adamw_delta(
                    self.adamw_index, grads, finite, on)):
                delta[i] = d
            for i, d in zip(self.muon_index, self._muon_delta(grads,
                                                              finite)):
                delta[i] = d
        else:  # SGD, torch.optim.SGD semantics
            momentum, nesterov = self.hyper["momentum"], self.hyper["nesterov"]
            buf = self.moments["momentum_buf"]
            decayed = torch._foreach_mul(params, self.wds)
            torch._foreach_add_(decayed, grads)
            torch._foreach_mul_(decayed, on)
            torch._foreach_mul_(buf, torch.where(finite, momentum, 1.0))
            torch._foreach_add_(buf, decayed)
            if nesterov:
                delta = torch._foreach_mul(buf, momentum)
                torch._foreach_add_(delta, decayed)
            else:
                delta = [b.clone() for b in buf]
        torch._foreach_mul_(delta, self.neg_lrmuls)
        torch._foreach_mul_(delta, lr_gate)
        torch._foreach_add_(params, delta)
        self.step += finite.to(torch.int64)

    def _adamw_delta(self, index, grads, finite, on):
        """AdamW's moments moved for the parameters ``index``; returns their
        updates before the lr (the Adam direction plus wd * p)."""
        b1, b2, eps = (self.hyper[k] for k in ("b1", "b2", "eps"))
        mu = [self.moments["mu"][i] for i in index]
        nu = [self.moments["nu"][i] for i in index]
        grads = [grads[i] for i in index]
        params = [self.params[i] for i in index]
        if not params:
            return []
        count = (self.step + 1).to(torch.float32)

        def gated(coefficient):  # (c, 1 - c) while on, (1, 0) while off
            c = torch.where(finite, coefficient, 1.0)
            return c, (1.0 - coefficient) * on

        b1_t, one_minus_b1 = gated(on.new_tensor(b1))
        b2_t, one_minus_b2 = gated(on.new_tensor(b2))
        torch._foreach_mul_(mu, b1_t)
        torch._foreach_add_(mu, torch._foreach_mul(grads, one_minus_b1))
        squares = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(squares, one_minus_b2)
        torch._foreach_mul_(nu, b2_t)
        torch._foreach_add_(nu, squares)
        denom = torch._foreach_div(nu, 1.0 - b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        delta = torch._foreach_div(mu, 1.0 - b1 ** count)
        torch._foreach_div_(delta, denom)
        torch._foreach_add_(delta, torch._foreach_mul(
            params, [self.wds[i] for i in index]))
        return delta

    def _muon_delta(self, grads, finite):
        """Muon's momentum moved for its parameters; returns their updates
        before the lr (the orthogonalised direction, scaled by 0.2 *
        sqrt(max(A, B)), plus wd * p). Matrices of one shape go through
        Newton-Schulz as one stack."""
        momentum, nesterov = self.hyper["momentum"], self.hyper["nesterov"]
        index = self.muon_index
        buf = [self.moments["muon_buf"][i] for i in index]
        grads = [grads[i] for i in index]
        if not buf:
            return []
        torch._foreach_mul_(buf, torch.where(finite, momentum, 1.0))
        torch._foreach_add_(buf, grads)
        if nesterov:
            eff = torch._foreach_mul(buf, momentum)
            torch._foreach_add_(eff, grads)
        else:
            eff = buf
        matrices = [muon_matrix(e, self.out_first[i])
                    for e, i in zip(eff, index)]
        groups = {}
        for k, m in enumerate(matrices):
            groups.setdefault(tuple(m.shape), []).append(k)
        delta = [None] * len(index)
        for shape, ks in groups.items():
            ortho = newton_schulz5(torch.stack([matrices[k] for k in ks]),
                                   self.hyper["ns_steps"])
            ortho = ortho * (0.2 * max(shape) ** 0.5)
            for k, o in zip(ks, ortho.unbind(0)):
                i = index[k]
                delta[k] = from_muon_matrix(o, self.params[i].shape,
                                            self.out_first[i])
        torch._foreach_add_(delta, torch._foreach_mul(
            [self.params[i] for i in index], [self.wds[i] for i in index]))
        return delta

    def state_dict(self):
        state = {"name": self.name, "step": self.step.clone()}
        for slot, tensors in self.moments.items():
            state[slot] = {n: t.clone() for n, t in zip(self.names, tensors)}
        return state

    @torch.no_grad()
    def load_state_dict(self, state):
        if state.get("name", self.name) != self.name:
            raise ValueError(f"optimizer state is {state['name']}'s, "
                             f"this optimizer is {self.name}")
        self.step.fill_(int(state["step"]))
        for slot, tensors in self.moments.items():
            for n, t in zip(self.names, tensors):
                t.copy_(torch.as_tensor(state[slot][n]))


def _out_first_weights(model):
    """Names of the parameters laid out output-first: the weights of the
    Linear and convolution layers (their Flax kernels are [in, out] and
    HWIO)."""
    return {f"{prefix}.weight" if prefix else "weight"
            for prefix, m in model.named_modules()
            if isinstance(m, (torch.nn.Linear, torch.nn.modules.conv._ConvNd))}


def build_optimizer(config, model, steps_per_epoch: int):
    """Build the optimizer and its schedule for a config.

    ``config`` has ``optimizer = (name, params_dict)``, ``scheduler = (name,
    params_dict)`` and ``epochs``; ``model`` is already on its device.
    Returns (optimizer, param-group report).
    """
    optimizer_name, optimizer_parameters = config.optimizer
    if optimizer_name not in SUPPORTED_OPTIMIZERS:
        raise ValueError(f"Unsupported optimizer {optimizer_name}: the port "
                         f"has {SUPPORTED_OPTIMIZERS}")
    scheduler_name, scheduler_parameters = config.scheduler

    lr = optimizer_parameters["lr"]
    schedule = build_schedule(scheduler_name, scheduler_parameters,
                              config.epochs, steps_per_epoch, lr)
    multipliers = [schedule(step)
                   for step in range(config.epochs * steps_per_epoch + 1)]

    named_params = list(model.named_parameters())
    names, wds, lrs, scales = compute_wd_and_lr(named_params,
                                                optimizer_parameters)
    if optimizer_name == "Muon":
        weight_decay = optimizer_parameters.get("weight_decay", 0.0)
        exclude = list(_STEM_LAYER_NAMES) + list(
            optimizer_parameters.get("exclude_muon_layer_name_list", [])
            or [])
        use_muon = [p.ndim >= 2 and not any(e in n for e in exclude)
                    for n, p in named_params]
        out_first = _out_first_weights(model)
        optimizer = Optimizer(
            "Muon", named_params, multipliers, [weight_decay] * len(names),
            [lr] * len(names), use_muon=use_muon,
            out_first=[n in out_first for n in names],
            momentum=optimizer_parameters.get("momentum", 0.95),
            nesterov=optimizer_parameters.get("nesterov", True),
            ns_steps=optimizer_parameters.get("ns_steps", 5),
            b1=optimizer_parameters.get("adamw_beta1", 0.9),
            b2=optimizer_parameters.get("adamw_beta2", 0.999),
            eps=optimizer_parameters.get("adamw_eps", 1e-8))
        report = [{"name": [n for n, u in zip(names, use_muon) if u],
                   "optimizer": "Muon", "lr": lr,
                   "weight_decay": weight_decay},
                  {"name": [n for n, u in zip(names, use_muon) if not u],
                   "optimizer": "AdamW", "lr": lr,
                   "weight_decay": weight_decay}]
        return optimizer, report
    lrmuls = [l_ * s_ for l_, s_ in zip(lrs, scales)]
    if optimizer_name == "SGD":
        hyper = dict(momentum=optimizer_parameters["momentum"],
                     nesterov=optimizer_parameters.get("nesterov", False))
    else:
        hyper = dict(b1=optimizer_parameters.get("beta1", 0.9),
                     b2=optimizer_parameters.get("beta2", 0.999),
                     eps=optimizer_parameters.get("eps", 1e-8))
    optimizer = Optimizer(optimizer_name, named_params, multipliers, wds,
                          lrmuls, **hyper)
    return optimizer, _group_report(names, wds, lrs, scales)
