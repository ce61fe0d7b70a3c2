"""Detection: for now only the COCO RLE mask codec (``rle.py``), which the
SAM dataset reads SA-1B masks with."""
