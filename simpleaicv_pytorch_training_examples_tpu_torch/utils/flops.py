"""FLOPs and parameter count of a model's forward.

Counterpart of the JAX package's ``utils/flops.py``. The FLOPs come from
``torch.utils.flop_counter.FlopCounterMode`` over one forward of zeros at
``input_shape`` (NCHW), in eval mode and without grad: it counts the
operations of matrix products, convolutions and attention (2 per
multiply-add) and nothing elementwise, where the JAX package's XLA
``cost_analysis`` counts every operation of the compiled program, so the
two counts differ by the elementwise work (normalisations, activations,
softmax). A hand-written kernel's launch is invisible to the counter, so the
count runs the model's plain attention and LayerNorm (the same products);
the model's switches are put back afterwards.
"""

import contextlib

import torch
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["compute_flops_and_params"]


@contextlib.contextmanager
def _plain_ops(model):
    """Within the block, ``model``'s layers take their plain torch paths."""
    switches = [(m, name) for m in model.modules()
                for name in ("use_fused_attention", "use_fused",
                             "use_fused_block")
                if getattr(m, name, False) is True]
    for m, name in switches:
        setattr(m, name, False)
    try:
        yield
    finally:
        for m, name in switches:
            setattr(m, name, True)


def compute_flops_and_params(model, input_shape, **forward_kwargs):
    """Returns (flops, params_count) of one forward of ``model`` on zeros of
    ``input_shape`` on the model's device."""
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    counter = FlopCounterMode(display=False)
    try:
        with torch.no_grad(), _plain_ops(model), counter:
            model(torch.zeros(input_shape, device=device), **forward_kwargs)
    finally:
        model.train(was_training)
    n_params = sum(p.numel() for p in model.parameters())
    return float(counter.get_total_flops()), int(n_params)
