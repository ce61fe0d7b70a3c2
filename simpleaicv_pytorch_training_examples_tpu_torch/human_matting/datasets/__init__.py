from .human_matting_dataset import HumanMattingDataset, ellipse_footprint

__all__ = ["HumanMattingDataset", "ellipse_footprint"]
