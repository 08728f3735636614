"""Tournament-lineage report over a population genealogy log
(``repro.launch.lineage``).

Reconstructs a champion's ancestry from the ``genealogy.jsonl`` that LTFB
training appends to (``repro_torch.launch.ltfb --ckpt-dir`` /
``--genealogy``; the JAX package's file reads the same) and the serving
arena of either package appends its ``promotion`` records to: which
trainer the champion descends from, every arena promotion and tournament
match where its model was adopted from a partner, rescale clones and
failure recoveries.  It reads the file only and touches no device.

  python -m repro_torch.launch.lineage --genealogy ckpts/genealogy.jsonl
  python -m repro_torch.launch.lineage --genealogy ckpts/genealogy.jsonl \
      --champion trainer_2 --json
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from repro_torch.train.telemetry import replay_genealogy


def summarize(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate counts over a genealogy record stream."""
    kinds: Dict[str, int] = {}
    rounds = -1
    trainers = 0
    for r in records:
        kinds[r.get("t", "?")] = kinds.get(r.get("t", "?"), 0) + 1
        if r.get("t") == "init":
            trainers = int(r.get("trainers", trainers))
        if r.get("t") == "rescale":
            trainers = int(r.get("to_k", trainers))
        if r.get("t") in ("round", "match") and "round" in r:
            rounds = max(rounds, int(r["round"]))
    return {"records": len(records), "kinds": kinds,
            "rounds": rounds + 1, "trainers": trainers}


def default_champion(records: List[Dict[str, Any]]) -> Optional[str]:
    """Latest arena champion, else the best trainer of the last round."""
    for r in reversed(records):
        if r.get("t") == "promotion":
            return str(r["winner"])
        if r.get("t") == "round" and "best_trainer" in r:
            return f"trainer_{int(r['best_trainer'])}"
    return None


def _trainer_index(name: str) -> int:
    if name.startswith("trainer_"):
        return int(name[len("trainer_"):])
    return int(name)


def ancestry(records: List[Dict[str, Any]], champion: str
             ) -> List[Dict[str, Any]]:
    """Walk the genealogy backward from ``champion``.

    Returns the chain of provenance events oldest-first: every record
    that changed whose model the champion's weights descend from
    (adopted tournament matches, rescale clones, failure recoveries,
    arena promotions), ending at the population init.
    """
    target = _trainer_index(champion)
    chain: List[Dict[str, Any]] = []
    for r in reversed(records):
        t = r.get("t")
        if t == "promotion" and str(r.get("winner")) == f"trainer_{target}":
            chain.append(r)
        elif t == "match" and int(r.get("trainer", -1)) == target \
                and r.get("adopted"):
            chain.append(r)
            target = int(r["partner"])
        elif t == "recover" and int(r.get("trainer", -1)) == target:
            chain.append(r)
            if r.get("cloned_from") is not None:
                target = int(r["cloned_from"])
        elif t == "rescale" and target in (r.get("cloned") or []):
            chain.append(r)
            if r.get("clone_src") is not None:
                target = int(r["clone_src"])
        elif t == "init":
            chain.append({**r, "root_trainer": target})
    chain.reverse()
    return chain


def _describe(r: Dict[str, Any]) -> str:
    t = r.get("t")
    if t == "init":
        return (f"root: trainer_{r.get('root_trainer', '?')} "
                f"(population init, {r.get('trainers', '?')} trainers, "
                f"seed {r.get('seed', '?')})")
    if t == "match":
        return (f"round {r.get('round', '?')}: trainer_{r['trainer']} "
                f"adopted the model of trainer_{r['partner']} "
                f"({r.get('m_other', float('nan')):.4g} beat "
                f"{r.get('m_local', float('nan')):.4g})")
    if t == "rescale":
        return (f"round {r.get('round', '?')}: rescale "
                f"{r.get('from_k', '?')}->{r.get('to_k', '?')} cloned "
                f"trainer_{r.get('clone_src', '?')} into "
                f"{['trainer_%d' % i for i in (r.get('cloned') or [])]}")
    if t == "recover":
        return (f"round {r.get('round', '?')}: trainer_{r['trainer']} "
                f"recovered from failure"
                + (f" as a clone of trainer_{r['cloned_from']}"
                   if r.get("cloned_from") is not None else ""))
    if t == "promotion":
        return (f"arena generation {r.get('generation', '?')}: "
                f"{r['winner']} dethroned {r.get('loser', '?')} at serve "
                f"step {r.get('step', '?')} "
                f"(accept rate {r.get('rate', float('nan')):.2f})")
    return json.dumps(r)


def build_parser() -> argparse.ArgumentParser:
    """The lineage CLI's argument parser."""
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.lineage",
        description="reconstruct a champion's ancestry from a "
                    "population genealogy log")
    ap.add_argument("--genealogy", required=True,
                    help="path to genealogy.jsonl (written under "
                         "--ckpt-dir by repro_torch.launch.ltfb)")
    ap.add_argument("--champion", default=None,
                    help="member to trace (e.g. trainer_2; default: "
                         "latest arena champion, else last round's "
                         "best trainer)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    return ap


def main(argv=None) -> int:
    """Entry point: print the lineage report, return exit status."""
    args = build_parser().parse_args(argv)
    records = replay_genealogy(args.genealogy)
    if not records:
        print(f"[lineage] no genealogy records in {args.genealogy!r}",
              file=sys.stderr)
        return 1
    champ = args.champion or default_champion(records)
    if champ is None:
        print("[lineage] cannot infer a champion — pass --champion",
              file=sys.stderr)
        return 1
    chain = ancestry(records, champ)
    summ = summarize(records)
    if args.json:
        print(json.dumps({"champion": champ, "summary": summ,
                          "ancestry": chain}))
        return 0
    print(f"[lineage] {args.genealogy}: {summ['records']} records, "
          f"{summ['rounds']} rounds, {summ['trainers']} trainers, "
          f"kinds={summ['kinds']}")
    print(f"[lineage] champion: {champ}")
    print("[lineage] ancestry (oldest first):")
    for r in chain:
        print(f"[lineage]   {_describe(r)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
