"""Stage logging (counterpart of ``qaig_tpu/utils/logging_utils.py``):
``%(asctime)s %(message)s`` to both ``<out>/<project>.log`` and stderr."""

import logging
import os


def setup_logging(out_dir, project_name, main_process=True):
    """``main_process=False`` (a rank other than 0) keeps the stream
    handler but not the shared log file, so ranks do not interleave
    writes."""
    handlers = [logging.StreamHandler()]
    if main_process:
        handlers.insert(0, logging.FileHandler(
            os.path.join(str(out_dir), f"{project_name}.log")))
    logging.basicConfig(format="%(asctime)s %(message)s", handlers=handlers,
                        level=logging.INFO, force=True)
    return logging.getLogger(project_name)
