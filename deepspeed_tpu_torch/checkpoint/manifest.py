"""Checkpoint integrity manifests + commit/retention helpers (counterpart
of `deepspeed_tpu/checkpoint/manifest.py`: the same manifest JSON, field
for field, so a checkpoint dir of either package verifies under the
other's `verify_manifest`).

Every committed checkpoint tag carries a `manifest.json` written INSIDE the
tag's staging dir before the rename-commit, recording:

  * per-leaf tree entries (key path, global shape, dtype),
  * a per-file content checksum (crc32) + byte size for every file in the tag,
  * the step, world/mesh shape and framework version that produced it.

A tag directory is *committed* iff it parses a manifest — the saver renames
`<tag>.tmp` -> `<tag>` only after the manifest (and everything it describes)
is durable, so a mid-save crash can never leave a committed-looking tag with
half-written state. Loaders use `verify_manifest` to detect corruption and
`committed_tags` to walk back to the newest good tag.

This module is deliberately stdlib-only (no torch import) so the offline
doctor CLI (`checkpoint/doctor.py`) can validate checkpoints without touching
a device runtime or deserializing any state.
"""

import json
import os
import pathlib
import shutil
import tempfile
import time
import zlib

MANIFEST_FILE = "manifest.json"
MANIFEST_FORMAT_VERSION = 1
TMP_SUFFIX = ".tmp"
LATEST_FILE = "latest"

_CHUNK = 4 * 2**20


class CheckpointCorruptionError(RuntimeError):
    """Raised when every retained checkpoint tag fails integrity validation."""


# ----------------------------------------------------------------------
# low-level durability primitives
# ----------------------------------------------------------------------


def fsync_file(path):
    fd = os.open(str(path), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path):
    """Persist directory entries (the rename itself) — no-op where unsupported."""
    try:
        fd = os.open(str(path), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_text(path, text):
    """Write a small text file via tempfile + rename so readers never observe
    a half-written (or empty) file — the `latest` pointer race fix."""
    path = pathlib.Path(path)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), prefix=path.name + ".",
                               suffix=TMP_SUFFIX)
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, str(path))
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    fsync_dir(path.parent)


def file_crc32(path):
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


# ----------------------------------------------------------------------
# manifest write / read / verify
# ----------------------------------------------------------------------


def _walk_files(root):
    """Relative paths of every regular file under root, sorted."""
    root = pathlib.Path(root)
    out = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in filenames:
            rel = os.path.relpath(os.path.join(dirpath, name), root)
            out.append(rel.replace(os.sep, "/"))
    return sorted(out)


def write_manifest(ckpt_dir, tag, step, tree=None, world=None, engine=None,
                   extra=None):
    """Checksum every file already present in `ckpt_dir` (the staging dir) and
    write + fsync `manifest.json` next to them. Must run BEFORE the
    rename-commit: the manifest's presence is the commit marker."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    files = {}
    total = 0
    for rel in _walk_files(ckpt_dir):
        if rel == MANIFEST_FILE:
            continue
        p = ckpt_dir / rel
        size = p.stat().st_size
        files[rel] = {"bytes": size, "crc32": f"{file_crc32(p):08x}"}
        total += size
        fsync_file(p)
    manifest = {
        "format_version": MANIFEST_FORMAT_VERSION,
        "tag": str(tag),
        "step": int(step),
        "created_unix": time.time(),
        "engine": engine,
        "world": world or {},
        "tree": tree or [],
        "files": files,
        "total_bytes": total,
    }
    if extra:
        manifest["extra"] = dict(extra)
    mpath = ckpt_dir / MANIFEST_FILE
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    fsync_dir(ckpt_dir)
    return manifest


def read_manifest(ckpt_dir):
    """Parse `<ckpt_dir>/manifest.json`; None if absent or unparseable."""
    mpath = pathlib.Path(ckpt_dir) / MANIFEST_FILE
    try:
        with open(mpath) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def is_committed(ckpt_dir):
    return read_manifest(ckpt_dir) is not None


def verify_manifest(ckpt_dir, template_tree=None, deep=True,
                    template_prefixes=None):
    """Validate a committed tag dir against its manifest.

    Checks: manifest parses; every listed file exists with the recorded size
    and (deep=True) crc32; optionally the recorded leaf tree matches
    `template_tree` (a list of {key, shape, dtype} entries — what the restore
    target expects). `template_prefixes` restricts the tree comparison to key
    prefixes (partial loads: module-only restores only care about params).

    Returns (ok: bool, errors: list[str]).
    """
    ckpt_dir = pathlib.Path(ckpt_dir)
    errors = []
    manifest = read_manifest(ckpt_dir)
    if manifest is None:
        return False, [f"{ckpt_dir}: missing or unparseable {MANIFEST_FILE}"]
    for rel, meta in manifest.get("files", {}).items():
        p = ckpt_dir / rel
        if not p.is_file():
            errors.append(f"missing file: {rel}")
            continue
        size = p.stat().st_size
        if size != meta.get("bytes"):
            errors.append(f"size mismatch: {rel} ({size} != {meta.get('bytes')})")
            continue
        if deep:
            crc = f"{file_crc32(p):08x}"
            if crc != meta.get("crc32"):
                errors.append(f"checksum mismatch: {rel} "
                              f"({crc} != {meta.get('crc32')})")
    if template_tree is not None and manifest.get("tree"):
        errors.extend(compare_trees(manifest["tree"], template_tree,
                                    prefixes=template_prefixes))
    return not errors, errors


def compare_trees(saved_tree, template_tree, prefixes=None):
    """Structural diff of two leaf-entry lists ({key, shape, dtype} each)."""
    def index(entries):
        out = {}
        for e in entries:
            k = e.get("key")
            if prefixes is not None and not any(
                    k == p or k.startswith(p + "/") for p in prefixes):
                continue
            out[k] = (list(e.get("shape") or []), e.get("dtype"))
        return out

    saved, tmpl = index(saved_tree), index(template_tree)
    errors = []
    for k in sorted(set(tmpl) - set(saved)):
        errors.append(f"leaf missing from checkpoint: {k}")
    for k in sorted(set(saved) - set(tmpl)):
        errors.append(f"unexpected leaf in checkpoint: {k}")
    for k in sorted(set(saved) & set(tmpl)):
        if saved[k][0] != tmpl[k][0]:
            errors.append(f"shape mismatch at {k}: "
                          f"saved {saved[k][0]} != expected {tmpl[k][0]}")
        elif saved[k][1] != tmpl[k][1]:
            errors.append(f"dtype mismatch at {k}: "
                          f"saved {saved[k][1]} != expected {tmpl[k][1]}")
    return errors


# ----------------------------------------------------------------------
# tag discovery / latest resolution
# ----------------------------------------------------------------------


def committed_tags(save_dir):
    """[(tag, step)] for every committed tag dir, newest (highest step,
    then mtime) first."""
    save_dir = pathlib.Path(save_dir)
    if not save_dir.is_dir():
        return []
    out = []
    for child in save_dir.iterdir():
        if not child.is_dir() or child.name.endswith(TMP_SUFFIX):
            continue
        m = read_manifest(child)
        if m is None:
            continue
        out.append((child.name, int(m.get("step", -1)), child.stat().st_mtime))
    out.sort(key=lambda t: (t[1], t[2]), reverse=True)
    return [(tag, step) for tag, step, _ in out]


def uncommitted_dirs(save_dir):
    """Tag-shaped dirs with NO manifest: in-flight `.tmp` staging dirs and
    legacy (pre-manifest) tags. Retention GC never touches these."""
    save_dir = pathlib.Path(save_dir)
    if not save_dir.is_dir():
        return []
    out = []
    for child in save_dir.iterdir():
        if child.is_dir() and read_manifest(child) is None:
            if child.name.endswith(TMP_SUFFIX) or (child / "state").exists() \
                    or (child / "client.json").exists():
                out.append(child.name)
    return sorted(out)


def resolve_latest_tag(save_dir):
    """Best-effort newest tag. The commit marker (manifest) is the source of
    truth, the `latest` pointer a hint: a committed tag with a HIGHER step
    than the pointed one wins (a crash between rename-commit and the pointer
    advance must not silently discard the newest committed checkpoint). The
    pointer is honored when it names the newest committed tag, when no newer
    committed tag exists, or for legacy manifest-less dirs. Returns None when
    nothing tag-like exists."""
    save_dir = pathlib.Path(save_dir)
    latest = save_dir / LATEST_FILE
    pointed = None
    if latest.exists():
        try:
            pointed = latest.read_text().strip() or None
        except OSError:
            pointed = None
    tags = committed_tags(save_dir)
    if pointed:
        pm = read_manifest(save_dir / pointed)
        if pm is not None:
            if tags and tags[0][0] != pointed \
                    and tags[0][1] > int(pm.get("step", -1)):
                return tags[0][0]  # newer committed tag than the pointer
            return pointed
    if tags:
        return tags[0][0]
    if pointed and (save_dir / pointed).is_dir():
        return pointed  # legacy pre-manifest layout
    legacy = [save_dir / t for t in uncommitted_dirs(save_dir)
              if not t.endswith(TMP_SUFFIX)]
    if legacy:
        return max(legacy, key=lambda p: p.stat().st_mtime).name
    return None


# ----------------------------------------------------------------------
# garbage collection / retention
# ----------------------------------------------------------------------


def gc_orphaned_tmp(save_dir, keep=None):
    """Remove `.tmp` staging dirs orphaned by crashed saves. `keep` names the
    staging dir of a save currently in flight. Returns removed names."""
    save_dir = pathlib.Path(save_dir)
    if not save_dir.is_dir():
        return []
    removed = []
    for child in save_dir.iterdir():
        if not child.is_dir() or not child.name.endswith(TMP_SUFFIX):
            continue
        if keep is not None and child.name == str(keep):
            continue
        shutil.rmtree(child, ignore_errors=True)
        removed.append(child.name)
    return removed


def retention_gc(save_dir, keep_last_n, protect=()):
    """Delete the oldest COMMITTED tags beyond `keep_last_n`. Uncommitted /
    legacy dirs are never deleted (they may be a save in flight, or the only
    copy of a pre-manifest checkpoint). Returns removed tags."""
    if keep_last_n is None or keep_last_n <= 0:
        return []
    save_dir = pathlib.Path(save_dir)
    protect = {str(p) for p in protect if p}
    removed = []
    for tag, _step in committed_tags(save_dir)[keep_last_n:]:
        if tag in protect:
            continue
        shutil.rmtree(save_dir / tag, ignore_errors=True)
        removed.append(tag)
    return removed
