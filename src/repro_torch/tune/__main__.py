"""CLI: measure a TuneTable on the live device and write it to JSON.

    PYTHONPATH=src python -m repro_torch.tune --smoke --out TUNE.json

Runs on the card unless the profile asks for the CPU
(``--profile cpu-dev``).  The file carries the measuring process's
runtime-profile stamp (backend ``cuda``, the card's name); a process that
loads it with ``TuneTable.from_json`` + ``tune.adopt`` installs it only
where the stamp matches.
"""

from __future__ import annotations

import argparse

from repro_torch.runtime import profile as rtprofile


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tune")
    ap.add_argument("--smoke", action="store_true",
                    help="small shapes (parity first, seconds not minutes)")
    ap.add_argument("--out", default="TUNE.json")
    ap.add_argument("--profile", default=None,
                    help="runtime profile to apply before measuring")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=None,
                    help="override the profile's seed policy")
    args = ap.parse_args(argv)

    rtprofile.apply(rtprofile.resolve(args.profile))
    from repro_torch.tune.autotuner import autotune

    table = autotune(smoke=args.smoke, seed=args.seed, repeats=args.repeats,
                     verbose=True)
    table.to_json(args.out)
    print(f"[tune] wrote {args.out}: {len(table.entries)} entries, "
          f"hash {table.table_hash()}, "
          f"backend {table.stamp['backend']}/{table.stamp['device_kind']}")


if __name__ == "__main__":
    main()
