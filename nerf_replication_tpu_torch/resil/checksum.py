"""Sidecar checksums for on-disk artifacts (.aot executables, occupancy
.npz): a truncated or bit-flipped artifact must degrade to lazy-jit /
rebuild, never load garbage into a serving replica.

A ``<file>.sha256`` sidecar carries the hex digest; the sidecar is
written atomically AFTER the artifact (tmp + ``os.replace``), so a crash
between the two leaves an artifact without a sidecar — which verifies as
"unknown" (None), not as valid. Verification is opt-out cheap: one
streamed read at load time, host-only.
"""

from __future__ import annotations

import hashlib
import os

SIDECAR_SUFFIX = ".sha256"


def file_sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        while True:
            block = fh.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def write_checksum(path: str) -> str:
    """Write ``path``'s digest sidecar atomically; the digest."""
    digest = file_sha256(path)
    sidecar = path + SIDECAR_SUFFIX
    tmp = f"{sidecar}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(digest + "\n")
    os.replace(tmp, sidecar)
    return digest


def _iter_tree_files(root: str):
    """Digest-relevant files under ``root``: sorted walk, sidecars and
    sidecar tmp files excluded (they describe the tree, they aren't it)."""
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for fname in sorted(filenames):
            if SIDECAR_SUFFIX in fname:
                continue
            yield os.path.join(dirpath, fname)


def tree_sha256(root: str, chunk: int = 1 << 20) -> str:
    """Digest of a directory tree: every file's root-relative path and
    content, in sorted order — the dir-level analogue of
    :func:`file_sha256` for artifacts that are directories (orbax scene
    checkpoints), where any torn member file must flip the digest."""
    h = hashlib.sha256()
    for path in _iter_tree_files(root):
        h.update(os.path.relpath(path, root).encode("utf-8") + b"\0")
        with open(path, "rb") as fh:
            while True:
                block = fh.read(chunk)
                if not block:
                    break
                h.update(block)
        h.update(b"\0")
    return h.hexdigest()


def write_tree_checksum(root: str) -> str:
    """Write a dir-tree digest sidecar (``<root>/tree.sha256``, atomic);
    the digest. Living INSIDE the tree, the sidecar travels with the
    checkpoint when a scene store is copied or scanned."""
    digest = tree_sha256(root)
    sidecar = os.path.join(root, "tree" + SIDECAR_SUFFIX)
    tmp = f"{sidecar}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(digest + "\n")
    os.replace(tmp, sidecar)
    return digest


def verify_tree_checksum(root: str) -> bool | None:
    """True = tree digest matches, False = mismatch (torn/corrupt scene
    checkpoint), None = unknown (no sidecar / unreadable)."""
    sidecar = os.path.join(root, "tree" + SIDECAR_SUFFIX)
    try:
        with open(sidecar, encoding="utf-8") as fh:
            expected = fh.read().strip()
    except OSError:
        return None
    if not expected:
        return None
    try:
        return tree_sha256(root) == expected
    except OSError:
        return None


def verify_checksum(path: str) -> bool | None:
    """True = digest matches, False = mismatch (torn/corrupt artifact),
    None = unknown (no sidecar, or either file unreadable — the caller's
    ordinary missing-file path handles it)."""
    sidecar = path + SIDECAR_SUFFIX
    try:
        with open(sidecar, encoding="utf-8") as fh:
            expected = fh.read().strip()
    except OSError:
        return None
    if not expected:
        return None
    try:
        return file_sha256(path) == expected
    except OSError:
        return None
