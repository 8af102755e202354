"""Stage logging (counterpart of ``qaig_tpu/utils/logging_utils.py``):
``%(asctime)s %(message)s`` to both ``<out>/<project>.log`` and stderr."""

import logging
import os


def setup_logging(out_dir, project_name):
    handlers = [logging.FileHandler(
                    os.path.join(str(out_dir), f"{project_name}.log")),
                logging.StreamHandler()]
    logging.basicConfig(format="%(asctime)s %(message)s", handlers=handlers,
                        level=logging.INFO, force=True)
    return logging.getLogger(project_name)
