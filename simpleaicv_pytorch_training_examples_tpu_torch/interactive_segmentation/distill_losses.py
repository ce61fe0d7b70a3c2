"""SAM encoder distillation loss.

Counterpart of the JAX package's ``interactive_segmentation/
distill_losses.py``: the mean squared difference of the teacher's and the
student's feature maps, in fp32.
"""

__all__ = ["MSELoss"]


class MSELoss:

    def __call__(self, tea_preds, stu_preds):
        diff = stu_preds.float() - tea_preds.float()
        return {"distill_mse_loss": diff.square().mean()}
