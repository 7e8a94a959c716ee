"""Offline feature-index build job.

Counterpart of ``photon_ml_tpu/cli/index.py``: one scan of the training
Avro builds the name+term index map of every feature shard (with the
intercept key unless ``--no-intercept``) and saves each in the index
store's layout (``data/index_map.py``). Host only; it takes no device:

    python -m photon_ml_tpu_torch.cli index --input train/ --output idx/ \\
        [--shards global:features,userFeatures user:userFeatures] \\
        [--no-intercept]
"""

from __future__ import annotations

import argparse
import json
import os

from photon_ml_tpu_torch.utils import logger, setup_logging, timed


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="photon_ml_tpu_torch.cli index",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--input", required=True, nargs="+", help=".avro files or directories")
    parser.add_argument("--output", required=True, help="index store directory")
    parser.add_argument("--shards", nargs="*", default=[],
                        help="shard specs 'name:bag1,bag2'; default one shard 'features' "
                        "from the 'features' bag")
    parser.add_argument("--no-intercept", action="store_true",
                        help="do not inject the intercept key")
    args = parser.parse_args(argv)
    setup_logging()

    from photon_ml_tpu_torch.data.avro import build_index_maps_from_avro

    shards: dict[str, tuple[str, ...]] = {}
    for spec in args.shards:
        name, _, bags = spec.partition(":")
        if not bags:
            raise SystemExit(f"bad shard spec '{spec}' (want name:bag1,bag2)")
        shards[name] = tuple(bags.split(","))
    if not shards:
        shards = {"features": ("features",)}

    summary = {}
    with timed(f"index {len(shards)} shard(s), one scan"):
        maps = build_index_maps_from_avro(args.input, shards,
                                          add_intercept=not args.no_intercept)
    for shard, imap in maps.items():
        out_dir = os.path.join(args.output, shard)
        imap.save(out_dir)
        logger.info("shard '%s': %d features -> %s", shard, len(imap), out_dir)
        summary[shard] = {"num_features": len(imap), "path": out_dir}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
