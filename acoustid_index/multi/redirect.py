"""Lineage redirect: data/<name>/current records the active generation and
whether the name is deleted; index data lives in v<generation>/ underneath.
Generation always increases across delete/recreate so lineages never mix —
the durable reconcile key against the meta feed
(cf. /root/reference/src/index_redirect.zig)."""

from __future__ import annotations

import os
from dataclasses import dataclass

from ..utils import mpack

REDIRECT_FILE = "current"


@dataclass(frozen=True)
class IndexRedirect:
    name: str
    generation: int
    deleted: bool = False

    def data_dir(self) -> str:
        return f"v{self.generation:06d}"

    def next_generation(self) -> "IndexRedirect":
        return IndexRedirect(name=self.name, generation=self.generation + 1, deleted=False)


def read_redirect(name_dir: str):
    path = os.path.join(name_dir, REDIRECT_FILE)
    try:
        with open(path, "rb") as f:
            d = mpack.unpackb(f.read())
    except FileNotFoundError:
        return None
    return IndexRedirect(name=d["n"], generation=d["g"], deleted=d.get("d", False))


def write_redirect(name_dir: str, redirect: IndexRedirect) -> None:
    path = os.path.join(name_dir, REDIRECT_FILE)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(
            mpack.packb(
                {"n": redirect.name, "g": redirect.generation, "d": redirect.deleted})
        )
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
