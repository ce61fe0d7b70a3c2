"""SAM2 streaming inference (test-time tracking).

Counterpart of the JAX package's
``video_interactive_segmentation/models/segment_anything2/sam2_stream.py``.
The step methods live on ``SAM2Video`` (``sam2.py``); this alias is the
test-time entry point:

    model = SAM2VideoStream(**sizes)
    feat, pos = model.encode_frame(images)            # [B, 3, H, W]
    (masks, ious, obj), carry = model.start_track(feat, prompts)
    for each next frame:
        feat, pos = model.encode_frame(images)
        (masks, ious, obj), carry = model.track_frame(feat, pos, carry)

``add_prompt_frame`` and ``add_mask_frame`` prompt a frame mid-stream. The
carry is a dict of device tensors of fixed shapes, so a video of any length
streams through the same steps.
"""

from .sam2 import SAM2Video

__all__ = ["SAM2VideoStream"]


class SAM2VideoStream(SAM2Video):
    """Alias exposing SAM2Video's streaming step methods as the test-time
    tracker."""
