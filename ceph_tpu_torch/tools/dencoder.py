# Copy of ceph_tpu/tools/dencoder.py at commit 38c1795, with its ceph_tpu
# references rebound to ceph_tpu_torch.
"""Wire-format round-trip checker (reference src/tools/ceph-dencoder).

The reference dencoder proves every versioned message/structure survives
encode -> decode across versions (backed by the ceph-object-corpus).  This
tool does the same for the framework's message registry: instantiate each
registered type with defaults, encode, decode, compare field dicts; flag
types whose wire version regressed vs a recorded corpus file.

    python -m ceph_tpu_torch.tools.dencoder list
    python -m ceph_tpu_torch.tools.dencoder roundtrip
    python -m ceph_tpu_torch.tools.dencoder corpus --write corpus.json
    python -m ceph_tpu_torch.tools.dencoder corpus --check corpus.json
    python -m ceph_tpu_torch.tools.dencoder golden     # replay corpus/wire

`golden` replays the archived binary frame corpus (corpus/wire/*.frame,
field-for-field) AND the golden old-build frames (corpus/wire/golden/ —
pre-trace v4, pre-qos MOSDOp v5), proving the truncated-tail decode
rule keeps every archived generation decodable."""

from __future__ import annotations

import argparse
import json
import sys

# importing types (+ mgr) populates the registry
import ceph_tpu_torch.mgr.daemon  # noqa: F401
import ceph_tpu_torch.rados.types  # noqa: F401
from ceph_tpu_torch.rados.messenger import _MSG_TYPES, decode_message, encode_payload


def cmd_list() -> int:
    for type_id in sorted(_MSG_TYPES):
        cls = _MSG_TYPES[type_id]
        print(f"{type_id:5d}  v{cls.VERSION}  {cls.__name__}")
    return 0


def cmd_roundtrip() -> int:
    failures = 0
    for type_id in sorted(_MSG_TYPES):
        cls = _MSG_TYPES[type_id]
        msg = cls()
        try:
            payload = encode_payload(msg)
            back = decode_message(type_id, cls.VERSION, payload)
            if back.__dict__ != msg.__dict__:
                print(f"FAIL {cls.__name__}: field mismatch after round-trip")
                failures += 1
        except Exception as e:
            print(f"FAIL {cls.__name__}: {type(e).__name__}: {e}")
            failures += 1
    print(f"{len(_MSG_TYPES) - failures}/{len(_MSG_TYPES)} types round-trip")
    return 1 if failures else 0


def corpus_snapshot() -> dict:
    return {
        cls.__name__: {"type_id": tid, "version": cls.VERSION,
                       "fields": sorted(cls().__dict__)}
        for tid, cls in _MSG_TYPES.items()
    }


def cmd_corpus(write: str = "", check: str = "") -> int:
    if not write and not check:
        print("corpus requires --write FILE or --check FILE", file=sys.stderr)
        return 2
    snap = corpus_snapshot()
    if write:
        with open(write, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
        print(f"corpus written: {len(snap)} types")
        return 0
    with open(check) as f:
        old = json.load(f)
    problems = 0
    for name, rec in old.items():
        cur = snap.get(name)
        if cur is None:
            print(f"REMOVED type {name} (wire id {rec['type_id']})")
            problems += 1
            continue
        if cur["type_id"] != rec["type_id"]:
            print(f"RE-NUMBERED {name}: {rec['type_id']} -> {cur['type_id']}")
            problems += 1
        if cur["version"] < rec["version"]:
            print(f"VERSION REGRESSION {name}: v{rec['version']} -> "
                  f"v{cur['version']}")
            problems += 1
        missing = set(rec["fields"]) - set(cur["fields"])
        if missing:
            # removed fields break decode of old pickled payloads
            print(f"FIELDS REMOVED from {name}: {sorted(missing)}")
            problems += 1
    print(f"corpus check: {problems} problems across {len(old)} types")
    return 1 if problems else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dencoder")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list")
    sub.add_parser("roundtrip")
    sub.add_parser("golden")
    c = sub.add_parser("corpus")
    c.add_argument("--write", default="")
    c.add_argument("--check", default="")
    args = p.parse_args(argv)
    if args.cmd == "list":
        return cmd_list()
    if args.cmd == "roundtrip":
        return cmd_roundtrip()
    if args.cmd == "golden":
        from ceph_tpu_torch.tools.wire_corpus import check

        return check()
    return cmd_corpus(args.write, args.check)


if __name__ == "__main__":
    import signal

    signal.signal(signal.SIGPIPE, signal.SIG_DFL)  # behave under | head
    sys.exit(main())
