"""Offline checkpoint validation & repair (counterpart of
`deepspeed_tpu/checkpoint/doctor.py`; run it as `python -m
deepspeed_tpu_torch.checkpoint.doctor <root>`). Its JSON report is the
JAX doctor's, key for key, so either reads the other's checkpoint roots.

Validates a checkpoint root (the dir holding `latest` + tag dirs) offline —
all validation logic lives in `checkpoint/manifest.py` (stdlib only; no
device runtime is touched and no state is deserialized). Reports, per tag:

  * committed vs uncommitted (manifest present), step, size,
  * integrity (every manifested file present, sized right, crc32-clean),
  * whether `latest` resolves to a committed, valid tag,

and can repair: `--gc` removes orphaned `.tmp` staging dirs from crashed
saves, `--fix-latest` rewrites a missing/stale `latest` to the newest valid
tag, `--keep-last-n N` applies the retention policy.

Exit code 0 iff at least one valid committed tag exists and `latest` (after
any `--fix-latest`) resolves to a valid tag.
"""

import argparse
import json
import pathlib

from deepspeed_tpu_torch.checkpoint import manifest as manifest_mod


def _tag_report(ckpt_dir, deep):
    m = manifest_mod.read_manifest(ckpt_dir)
    if m is None:
        return {"tag": ckpt_dir.name, "committed": False, "valid": False,
                "errors": ["no manifest (legacy or interrupted save)"]}
    ok, errors = manifest_mod.verify_manifest(ckpt_dir, deep=deep)
    return {"tag": ckpt_dir.name, "committed": True, "valid": ok,
            "step": m.get("step"), "engine": m.get("engine"),
            "bytes": m.get("total_bytes"),
            "world": m.get("world", {}), "errors": errors}


def diagnose(root, deep=True):
    """Full report dict for a checkpoint root."""
    root = pathlib.Path(root)
    report = {"root": str(root), "tags": [], "orphaned_tmp": [],
              "latest": None, "latest_valid": False, "newest_valid_tag": None}
    if not root.is_dir():
        report["error"] = "not a directory"
        return report
    latest_file = root / manifest_mod.LATEST_FILE
    if latest_file.exists():
        try:
            report["latest"] = latest_file.read_text().strip() or None
        except OSError:
            pass
    for child in sorted(root.iterdir()):
        if not child.is_dir():
            continue
        if child.name.endswith(manifest_mod.TMP_SUFFIX):
            report["orphaned_tmp"].append(child.name)
            continue
        if manifest_mod.read_manifest(child) is None \
                and not (child / "state").exists() \
                and not (child / "client.json").exists():
            continue  # unrelated directory
        report["tags"].append(_tag_report(child, deep))
    valid = [t for t in report["tags"] if t["valid"]]
    if valid:
        report["newest_valid_tag"] = max(
            valid, key=lambda t: t.get("step") or -1)["tag"]
    report["latest_valid"] = any(t["tag"] == report["latest"] and t["valid"]
                                 for t in report["tags"])
    return report


def _print_human(report):
    print(f"checkpoint root: {report['root']}")
    if report.get("error"):
        print(f"  ERROR: {report['error']}")
        return
    for t in sorted(report["tags"], key=lambda t: (t.get("step") is None,
                                                   t.get("step") or 0)):
        status = ("OK" if t["valid"] else
                  "CORRUPT" if t["committed"] else "UNCOMMITTED")
        size = t.get("bytes")
        size_s = f"{size / 2**20:8.1f} MiB" if isinstance(size, (int, float)) \
            else "        ?"
        step = t.get("step")
        print(f"  [{status:11s}] {t['tag']:<24s} step={step!s:<8s} {size_s}")
        for err in t.get("errors", [])[:5]:
            print(f"               - {err}")
        extra = len(t.get("errors", [])) - 5
        if extra > 0:
            print(f"               - (+{extra} more)")
    for name in report["orphaned_tmp"]:
        print(f"  [ORPHANED   ] {name}  (crashed save staging dir)")
    latest = report["latest"]
    if latest is None:
        print("  latest: MISSING", end="")
    else:
        print(f"  latest -> {latest} "
              f"({'valid' if report['latest_valid'] else 'INVALID/stale'})",
              end="")
    nv = report["newest_valid_tag"]
    print(f"  | newest valid tag: {nv if nv else 'NONE'}")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.checkpoint.doctor",
        description="validate (and optionally repair) a deepspeed-tpu "
                    "checkpoint directory offline")
    parser.add_argument("checkpoint_dir", help="checkpoint root "
                        "(contains `latest` and tag dirs)")
    parser.add_argument("--tag", default=None,
                        help="validate only this tag")
    parser.add_argument("--fast", action="store_true",
                        help="skip crc32 content checksums (existence+size only)")
    parser.add_argument("--gc", action="store_true",
                        help="remove orphaned .tmp staging dirs")
    parser.add_argument("--fix-latest", action="store_true",
                        help="rewrite `latest` to the newest valid tag when "
                             "missing or pointing at an invalid tag")
    parser.add_argument("--keep-last-n", type=int, default=0,
                        help="apply retention: delete committed tags beyond "
                             "the newest N (never touches uncommitted dirs)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit the report as JSON")
    args = parser.parse_args(argv)

    root = pathlib.Path(args.checkpoint_dir)
    deep = not args.fast

    if args.tag is not None:
        t = _tag_report(root / args.tag, deep)
        if args.as_json:
            print(json.dumps(t, indent=2))
        else:
            _print_human({"root": str(root), "tags": [t], "orphaned_tmp": [],
                          "latest": None, "latest_valid": False,
                          "newest_valid_tag": t["tag"] if t["valid"] else None})
        return 0 if t["valid"] else 1

    report = diagnose(root, deep=deep)
    actions = {}
    if args.gc:
        actions["removed_tmp"] = manifest_mod.gc_orphaned_tmp(root)
        report["orphaned_tmp"] = []
    if args.fix_latest and not report["latest_valid"] \
            and report["newest_valid_tag"]:
        manifest_mod.atomic_write_text(root / manifest_mod.LATEST_FILE,
                                       report["newest_valid_tag"])
        report["latest"] = report["newest_valid_tag"]
        report["latest_valid"] = True
        actions["fixed_latest"] = report["newest_valid_tag"]
    if args.keep_last_n > 0:
        protect = (report["latest"], report["newest_valid_tag"])
        actions["retention_removed"] = manifest_mod.retention_gc(
            root, args.keep_last_n, protect=protect)
        report = diagnose(root, deep=False) | {"actions": actions}
    if actions:
        report["actions"] = actions

    if args.as_json:
        print(json.dumps(report, indent=2))
    else:
        _print_human(report)
        for k, v in actions.items():
            print(f"  action {k}: {v}")

    healthy = report["newest_valid_tag"] is not None and (
        report["latest_valid"] or report["latest"] is None)
    return 0 if healthy else 1


if __name__ == "__main__":
    raise SystemExit(main())
