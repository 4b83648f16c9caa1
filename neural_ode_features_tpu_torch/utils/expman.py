"""Experiment management: deterministic run directories from hyperparams
(the port's own copy of ``neural_ode_features_tpu/utils/expman.py``; the
same dict gives the same directory name and the same ``params.json`` bytes
under both packages, so a run directory is shared between them).

A run directory's name is derived from the hyperparameter dict, with
``params.json`` persisted (so ``extract`` can rebuild the exact
architecture) and an appendable ``log.csv``.
"""

from __future__ import annotations

import csv
import hashlib
import json
import re
from pathlib import Path

__all__ = ["Experiment"]


def _abbrev(key: str) -> str:
    """batch_size → batch_size (full keys: abbreviations collide — e.g.
    adjoint/augment; the reference's expman also uses full names).
    Long names are safe regardless: name_from_params caps at 200 chars
    with a collision-proof digest tail (pinned by tests/test_expman.py),
    well under every filesystem's 255-byte filename limit."""
    return key


def _fmt(val) -> str:
    if isinstance(val, bool):
        return str(val)
    if isinstance(val, float):
        return f"{val:g}"
    return re.sub(r"[^A-Za-z0-9.+-]", "", str(val))


class Experiment:
    """A run directory: ``<root>/<name>`` with params.json + log.csv.

    ``name`` is deterministic in the param dict (sorted ``abbrev=value``
    pairs), so re-launching with identical hyperparameters resumes the same
    directory — the reference's expman lookup/resume behaviour.
    """

    PARAMS_FILE = "params.json"
    LOG_FILE = "log.csv"

    def __init__(self, root: str | Path, params: dict, name: str | None = None):
        self.params = dict(params)
        self.name = name or self.name_from_params(params)
        self.path = Path(root) / self.name

    @staticmethod
    def name_from_params(params: dict) -> str:
        items = sorted(params.items())
        name = "-".join(f"{_abbrev(k)}_{_fmt(v)}" for k, v in items)
        if len(name) > 200:
            # Truncation alone made distinct experiments collide (the cut
            # tail held seed/tol/model for the default train.py params) and
            # silently cross-resume each other's state — disambiguate with a
            # digest of the full parameter string.
            digest = hashlib.sha1(name.encode()).hexdigest()[:12]
            name = f"{name[:186]}-{digest}"
        return name

    # -- lifecycle -----------------------------------------------------------
    def create(self) -> "Experiment":
        self.path.mkdir(parents=True, exist_ok=True)
        params_file = self.path / self.PARAMS_FILE
        if params_file.exists():
            existing = json.loads(params_file.read_text())
            rendered = json.loads(
                json.dumps(self.params, sort_keys=True, default=str)
            )
            if existing != rendered:
                raise ValueError(
                    f"run dir {self.path} already holds a DIFFERENT experiment"
                    " (params.json mismatch) — refusing to overwrite/resume it"
                )
        with open(params_file, "w") as f:
            json.dump(self.params, f, indent=2, sort_keys=True, default=str)
        return self

    @property
    def exists(self) -> bool:
        return (self.path / self.PARAMS_FILE).exists()

    @classmethod
    def from_dir(cls, run_dir: str | Path) -> "Experiment":
        run_dir = Path(run_dir)
        with open(run_dir / cls.PARAMS_FILE) as f:
            params = json.load(f)
        exp = cls(run_dir.parent, params, name=run_dir.name)
        return exp

    # -- logging -------------------------------------------------------------
    def log(self, row: dict) -> None:
        """Append one CSV row (header written on first call; schema fixed by
        the first row — the reference's per-epoch log.csv).

        The schema is ENFORCED against the existing header: a resumed run
        (or a code change adding a column) whose keys differ would otherwise
        write values under the wrong columns with no error.
        """
        log_path = self.path / self.LOG_FILE
        new = not log_path.exists()
        if not new:
            with open(log_path, newline="") as f:
                header = next(csv.reader(f), None) or []
            if header and list(row.keys()) != header:
                raise ValueError(
                    f"log.csv schema mismatch: existing header {header} != "
                    f"row keys {list(row.keys())} — the per-epoch schema is "
                    "fixed by the first row of the run"
                )
        with open(log_path, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(row.keys()))
            if new:
                writer.writeheader()
            writer.writerow(row)

    def read_log(self) -> list[dict]:
        log_path = self.path / self.LOG_FILE
        if not log_path.exists():
            return []
        with open(log_path) as f:
            return list(csv.DictReader(f))

    def file(self, name: str) -> Path:
        return self.path / name
