"""Offline dataset-statistics CLIs — the `yolo/utilities/get_idf.py` and
`yolo/utilities/kmeans_anchors.py` twins (port of the JAX package's
``tools.py``, with the same printed lines and files).

Usage:
  python -m object_detectors_tpu_torch.tools get-idf <annotations.json> out/
  python -m object_detectors_tpu_torch.tools kmeans-anchors <annotations.json>
      [--num-anchors 9] [--img-size 416]
  python -m object_detectors_tpu_torch.tools compare-maps <gt.json>
      name1=dets1.json name2=dets2.json [--csv out.csv]
  python -m object_detectors_tpu_torch.tools disagreement <gt.json>
      <dets_a.json> <dets_b.json>
"""

from __future__ import annotations

import argparse
import json
import os


def _load(path):
    with open(path) as f:
        return json.load(f)


def cmd_get_idf(args):
    from object_detectors_tpu_torch.data import idf

    gt = _load(args.annotations)
    tables = idf.idf_tables(gt)
    out = os.path.join(args.out_dir, "idf.csv")
    idf.save_idf_csv(tables, out)
    print(f"wrote {out} ({len(tables['_kept_category_ids'])} classes)")


def cmd_kmeans(args):
    from object_detectors_tpu_torch.analysis import compare

    gt = _load(args.annotations)
    anchors = compare.kmeans_anchors(gt, args.num_anchors, args.img_size)
    print(json.dumps({"anchors": anchors}))


def cmd_compare(args):
    from object_detectors_tpu_torch.analysis import compare

    gt = _load(args.gt)
    results = {}
    for spec in args.results:
        name, _, path = spec.partition("=")
        results[name] = path
    rows = compare.per_category_table(gt, results)
    if args.csv:
        import csv

        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {args.csv}")
    else:
        for r in rows[:40]:
            print(r)


def cmd_disagreement(args):
    from object_detectors_tpu_torch.analysis import compare

    gt = _load(args.gt)
    out = compare.mcnemar_disagreement(gt, args.dets_a, args.dets_b)
    print(json.dumps(out))


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("get-idf")
    p.add_argument("annotations")
    p.add_argument("out_dir")
    p.set_defaults(fn=cmd_get_idf)

    p = sub.add_parser("kmeans-anchors")
    p.add_argument("annotations")
    p.add_argument("--num-anchors", type=int, default=9)
    p.add_argument("--img-size", type=int, default=416)
    p.set_defaults(fn=cmd_kmeans)

    p = sub.add_parser("compare-maps")
    p.add_argument("gt")
    p.add_argument("results", nargs="+", help="name=dets.json pairs")
    p.add_argument("--csv", default=None)
    p.set_defaults(fn=cmd_compare)

    p = sub.add_parser("disagreement")
    p.add_argument("gt")
    p.add_argument("dets_a")
    p.add_argument("dets_b")
    p.set_defaults(fn=cmd_disagreement)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
