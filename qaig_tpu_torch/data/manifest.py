"""TinyDB-compatible JSON manifests (counterpart of
``qaig_tpu/data/manifest.py``; no tinydb dependency).

The on-disk layout is TinyDB's::

    {"_default": {"1": {...row...}, "2": {...row...}, ...}}

so datasets are interchangeable with ``qaig_tpu`` and the reference
pipeline in both directions.
"""

import json
import os


class Manifest:
    """Read/write a TinyDB-format JSON manifest."""

    TABLE = "_default"

    def __init__(self, path, load=True):
        self.path = str(path)
        if load and os.path.exists(self.path):
            with open(self.path, "r") as f:
                raw = json.load(f)
            table = raw.get(self.TABLE, {})
            # TinyDB doc ids are 1-based stringified ints; keep their order.
            self.rows = [table[k] for k in
                         sorted(table.keys(), key=lambda s: int(s))]
        else:
            self.rows = []

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, index):
        return self.rows[index]

    def save(self, path=None):
        path = str(path or self.path)
        table = {str(i + 1): row for i, row in enumerate(self.rows)}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({self.TABLE: table}, f)
        os.replace(tmp, path)
        return path


def write_manifest(path, rows):
    """Write ``rows`` to ``path``, replacing any existing manifest."""
    m = Manifest(path, load=False)
    m.rows = list(rows)
    return m.save()
