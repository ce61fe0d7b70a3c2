"""Work-dir python-config loading.

``sys.path.append(work_dir); from test_config import config``: the config is
a plain python class whose body runs at import and builds live objects
(model, datasets, collaters). This idiom is the framework's public API.
"""

import importlib
import os
import sys


def load_config_from_work_dir(work_dir: str, module_name: str = "train_config"):
    work_dir = os.path.abspath(work_dir)
    if work_dir not in sys.path:
        sys.path.insert(0, work_dir)
    # Force a fresh import if a same-named module from another work dir is
    # already loaded (tests load several experiment dirs in one process).
    if module_name in sys.modules:
        mod = sys.modules[module_name]
        if getattr(mod, "__file__", "") != os.path.join(
                work_dir, module_name + ".py"):
            del sys.modules[module_name]
            mod = importlib.import_module(module_name)
        else:
            mod = importlib.reload(mod)
    else:
        mod = importlib.import_module(module_name)
    return mod.config
