"""ImageNet-21K(-P) with the semantic tree's hierarchical labels.

Counterpart of the JAX package's ``imagenet21kdataset.py``: folder-per-class
images (decoded by the native libjpeg core, as ``ilsvrc2012dataset.py``)
plus the MIIL semantic tree (``imagenet21k_miil_tree.pth``:
``class_tree_list``, each class's chain of ancestors). Without a tree file
the tree is the degenerate one-level tree, one class per level-0 node. The
conversions that ``SemanticSoftmaxLoss`` needs:

- ``normalization_factor_list``: per-level weights, proportional to the
  number of classes at the level;
- ``hierarchy_class_lists``: the classes of each level, so that a level's
  logits are ``outputs[:, classes]``
  (``convert_outputs_to_semantic_outputs``);
- ``semantic_label_table`` [classes, levels]: a class's index within each
  level, -1 where the class does not reach the level
  (``convert_single_labels_to_semantic_labels``).
"""

import os

import numpy as np
import torch

from ...native import lib
from .ilsvrc2012dataset import decode_image, list_class_folders


class ImageNet21KSemanticTreeLabelDataset:

    def __init__(self, root_dir, set_name="train", transform=None,
                 tree_path=None):
        self.transform = transform
        self.class_to_idx, self.image_paths, self.labels = \
            list_class_folders(os.path.join(root_dir, set_name))
        if self.image_paths:
            lib()
        self._build_tree(tree_path or os.path.join(
            root_dir, "imagenet21k_miil_tree.pth"))

    def _build_tree(self, tree_path):
        if os.path.exists(tree_path):
            class_tree_list = torch.load(tree_path, map_location="cpu",
                                         weights_only=True)["class_tree_list"]
        else:
            class_tree_list = [[i] for i in
                               range(max(len(self.class_to_idx), 1))]
        self.class_tree_list = class_tree_list
        self.max_hierarchy = max(len(t) for t in class_tree_list)
        self.hierarchy_class_lists, index_maps = [], []
        for level in range(self.max_hierarchy):
            classes = sorted({t[level] for t in class_tree_list
                              if len(t) > level})
            self.hierarchy_class_lists.append(np.asarray(classes, np.int64))
            index_maps.append({c: i for i, c in enumerate(classes)})
        sizes = np.asarray([len(c) for c in self.hierarchy_class_lists],
                           np.float64)
        self.normalization_factor_list = (sizes / sizes.sum()).tolist()
        table = np.full((len(class_tree_list), self.max_hierarchy), -1,
                        np.int64)
        for cls, ancestors in enumerate(class_tree_list):
            for level, ancestor in enumerate(ancestors):
                table[cls, level] = index_maps[level][ancestor]
        self.semantic_label_table = table

    def convert_single_labels_to_semantic_labels(self, labels):
        return self.semantic_label_table[np.asarray(labels, np.int64)]

    def convert_outputs_to_semantic_outputs(self, outputs):
        """outputs [B, classes] -> [B, C_level] for each level."""
        return [outputs[:, torch.as_tensor(classes, device=outputs.device)]
                for classes in self.hierarchy_class_lists]

    def __len__(self):
        return len(self.image_paths)

    def __getitem__(self, idx):
        sample = {"image": decode_image(self.image_paths[idx]).astype(
                      np.float32),
                  "label": int(self.labels[idx])}
        if self.transform is not None:
            sample = self.transform(sample)
        return sample
