"""Build manifest: the resume ledger of the staged pipeline
(``repro.storage.pipeline.manifest``; the same JSON, with the kind of
device in the fingerprint).

One JSON file per build, living in the build's work directory next to the
run files and the partial index.  It records

  * a **fingerprint** of everything that determines the output bytes
    (source file identity, n/w/card/capacity, normalize, extra, format
    version, the kind of device that z-normalizes) — a resume against a manifest whose fingerprint differs is
    a DIFFERENT build and starts fresh;
  * the **layout** the driver planned (shard ranges, permute-unit rows):
    resume always reuses the recorded layout, so a caller changing
    ``chunk``/``workers`` between attempts cannot shift unit boundaries
    under completed work;
  * per-stage **unit records**: each completed unit of work (a sorted
    run, the merge, the summary sections, one permute unit, publish) is
    recorded — with sha256+size for the stages that produce standalone
    files — only AFTER its bytes are flushed, so a SIGKILL at any point
    leaves a manifest whose records are all true.

Every save is atomic (temp + fsync + rename): the manifest itself can
never be read half-written.  The driver's resume rule is then one line:
a unit is skipped iff its record exists and (for file-producing units)
its file still checks out.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from pathlib import Path

MANIFEST_VERSION = 1
STAGES = ("runs", "merge", "summaries", "permute", "publish")


def file_digest(path: str | Path, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                return h.hexdigest()
            h.update(b)


def file_record(path: str | Path) -> dict:
    """The integrity record stored for a unit that produced ``path``."""
    return {"path": Path(path).name, "bytes": os.path.getsize(path),
            "sha256": file_digest(path)}


def file_ok(path: str | Path, record: dict) -> bool:
    """Does ``path`` still match its manifest record? (resume validation)"""
    path = Path(path)
    if not path.exists() or os.path.getsize(path) != record["bytes"]:
        return False
    return file_digest(path) == record["sha256"]


@dataclasses.dataclass
class Manifest:
    path: Path
    data: dict

    @classmethod
    def fresh(cls, path: str | Path, *, fingerprint: dict,
              layout: dict) -> "Manifest":
        m = cls(Path(path), {
            "manifest_version": MANIFEST_VERSION,
            "fingerprint": fingerprint,
            "layout": layout,
            "stages": {s: {} for s in STAGES},
        })
        m.save()
        return m

    @classmethod
    def load(cls, path: str | Path) -> "Manifest | None":
        path = Path(path)
        if not path.exists():
            return None
        try:
            data = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            return None        # unreadable ledger == no ledger
        if data.get("manifest_version") != MANIFEST_VERSION:
            return None
        return cls(path, data)

    @property
    def fingerprint(self) -> dict:
        return self.data["fingerprint"]

    @property
    def layout(self) -> dict:
        return self.data["layout"]

    def units(self, stage: str) -> dict:
        """unit-id -> record for every COMPLETED unit of ``stage``."""
        return self.data["stages"][stage]

    def record_unit(self, stage: str, unit: str, record: dict | None = None,
                    save: bool = True) -> None:
        self.data["stages"][stage][str(unit)] = record or {}
        if save:
            self.save()

    def clear_stage(self, *stages: str, save: bool = True) -> None:
        for s in stages:
            self.data["stages"][s] = {}
        if save:
            self.save()

    def save(self) -> None:
        tmp = self.path.with_name(self.path.name + ".tmp")
        with open(tmp, "w") as f:
            json.dump(self.data, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
