"""CLI dispatcher: python -m photon_ml_tpu_torch.cli {train|refresh|pipeline|sweep|score|serve|glm|index} ...

Counterpart of ``photon_ml_tpu/cli/__main__.py``, with the same usage text
and dispatch. ``report`` and ``profile`` raise ``NotImplementedError``
(ROADMAP.md Queue 1 item 14d). ``train``, ``refresh``, ``pipeline``,
``sweep``, ``score``, ``serve`` and ``glm`` take ``--device`` (default
``cuda``).
"""

import sys

_NOT_PORTED = {"report": "14d", "profile": "14d"}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m photon_ml_tpu_torch.cli {train|refresh|pipeline|sweep|score|serve|glm|index|report|profile} [options]")
        print("  train --config <json> [--output-dir <dir>] [--device cuda|cpu]   GAME training")
        print("  refresh --config <json> --warm-start <dir> [--delta <path>] [--registry-dir <dir>] "
              "[--device cuda|cpu]   incremental warm-start retrain")
        print("  pipeline --config <json> --base <dir> --delta-dir <dir> --registry-dir <dir> "
              "--workdir <dir> [--device cuda|cpu]   freshness conductor daemon")
        print("  report, profile   not ported (ROADMAP.md Queue 1 item 14d)")
        print("  sweep --config <json> [--sweep lambda=...] [--device cuda|cpu]   multi-lambda "
              "sweep + selection")
        print("  score --model-dir <dir> --config <json> [--output <avro>] [--device cuda|cpu]")
        print("  serve (--model-dir <dir>|--registry-dir <dir>) [--stdio] [--device cuda|cpu]   "
              "online scoring")
        print("  glm   --config <json> [--output-dir <dir>] [--device cuda|cpu]   staged legacy GLM")
        print("  index --input <avro...> --output <dir>       feature index build")
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd in _NOT_PORTED:
        raise NotImplementedError(
            f"the '{cmd}' subcommand is not ported to photon_ml_tpu_torch yet "
            f"(ROADMAP.md Queue 1 item {_NOT_PORTED[cmd]})")
    if cmd == "train":
        from photon_ml_tpu_torch.cli.train import main as train_main

        return train_main(rest)
    if cmd == "refresh":
        from photon_ml_tpu_torch.cli.refresh import main as refresh_main

        return refresh_main(rest)
    if cmd == "pipeline":
        from photon_ml_tpu_torch.cli.pipeline import main as pipeline_main

        return pipeline_main(rest)
    if cmd == "sweep":
        from photon_ml_tpu_torch.cli.sweep import main as sweep_main

        return sweep_main(rest)
    if cmd == "score":
        from photon_ml_tpu_torch.cli.score import main as score_main

        return score_main(rest)
    if cmd == "serve":
        from photon_ml_tpu_torch.cli.serve import main as serve_main

        return serve_main(rest)
    if cmd == "glm":
        from photon_ml_tpu_torch.cli.glm import main as glm_main

        return glm_main(rest)
    if cmd == "index":
        from photon_ml_tpu_torch.cli.index import main as index_main

        return index_main(rest)
    print(f"unknown command '{cmd}' (expected train|refresh|pipeline|sweep|score|serve|glm|"
          "index|report|profile)", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
