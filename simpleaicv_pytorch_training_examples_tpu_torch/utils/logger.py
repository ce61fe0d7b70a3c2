"""Per-run logger with a rotating file handler and a console handler.

One named logger per run writes ``<log_dir>/<name>.log``. Calling again with
another ``log_dir`` (several runs in one process) moves the logger there.
"""

import logging
import logging.handlers
import os


def get_logger(name: str, log_dir: str) -> logging.Logger:
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(log_dir, f"{name}.log"))
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    if any(getattr(h, "baseFilename", None) == path for h in logger.handlers):
        return logger
    for handler in list(logger.handlers):
        logger.removeHandler(handler)
        handler.close()

    fmt = logging.Formatter("%(asctime)s %(levelname)s: %(message)s")
    file_handler = logging.handlers.TimedRotatingFileHandler(
        path, when="W0", encoding="utf-8")
    file_handler.setFormatter(fmt)
    logger.addHandler(file_handler)

    stream_handler = logging.StreamHandler()
    stream_handler.setFormatter(fmt)
    logger.addHandler(stream_handler)

    logger.propagate = False
    return logger
