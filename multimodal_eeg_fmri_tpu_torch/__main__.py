"""CLI: ``python -m multimodal_eeg_fmri_tpu_torch --pipeline
eeg|fmri|bridge|lite|all``. Counterpart of
``multimodal_eeg_fmri_tpu/__main__.py``.

The reference has no CLI (``argparse`` is imported in the EEG notebook but
never used — SURVEY §5); its entry points are scripts/notebooks run
top-to-bottom. This exposes the same four pipelines behind flags, with an
optional config overlay (YAML where PyYAML is installed, JSON always). The
pipelines run on the card; ``--cpu`` asks for the CPU, and without a card
and without ``--cpu`` the run raises.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="multimodal_eeg_fmri_tpu_torch",
        description="multimodal EEG+fMRI pipelines in PyTorch on an NVIDIA "
                    "GPU",
    )
    p.add_argument("--pipeline",
                   choices=["eeg", "fmri", "bridge", "lite", "all"],
                   required=True,
                   help="'all' runs eeg -> fmri -> bridge -> lite "
                        "back-to-back (the complete reference workload; "
                        "the reference needs 4 separate scripts/notebooks)")
    p.add_argument("--config",
                   help="config overlay path (YAML, or JSON without PyYAML)")
    p.add_argument("--output-dir", help="override output directory")
    p.add_argument("--seed", type=int, help="override RNG seed")
    p.add_argument("--epochs", type=int, help="override epoch count")
    p.add_argument("--no-export", action="store_true")
    p.add_argument("--aot-dir", default=None, metavar="DIR",
                   help="AOT bundle cache directory (eeg/fmri pipelines): "
                        "each model's evaluation program is exported there "
                        "once and loaded by later runs without tracing")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the GPU")
    args = p.parse_args(argv)

    import dataclasses

    from multimodal_eeg_fmri_tpu_torch.core.config import (
        ExperimentConfig,
        load_config,
    )

    cfg = load_config(args.config) if args.config else ExperimentConfig()
    if args.output_dir:
        cfg = dataclasses.replace(cfg, output_dir=args.output_dir)
    if args.seed is not None or args.epochs is not None:
        train = cfg.train
        if args.seed is not None:
            train = dataclasses.replace(train, seed=args.seed)
        if args.epochs is not None:
            train = dataclasses.replace(train, num_epochs=args.epochs)
        cfg = dataclasses.replace(cfg, train=train)

    from multimodal_eeg_fmri_tpu_torch import pipelines

    export = not args.no_export
    device = "cpu" if args.cpu else "cuda"
    if args.pipeline == "all":
        summary = {}
        out = {}
        out["eeg"] = pipelines.run_eeg_experiment(cfg, export=export,
                                                  aot_dir=args.aot_dir,
                                                  device=device)
        summary["eeg"] = {m: r.summary
                          for m, r in out["eeg"]["kfold"].items()}
        out["fmri"] = pipelines.run_fmri_experiment(cfg, export=export,
                                                    aot_dir=args.aot_dir,
                                                    device=device)
        summary["fmri"] = {m: r.summary
                           for m, r in out["fmri"]["classification"].items()}
        out["bridge"] = pipelines.run_bridge_experiment(cfg, export=export,
                                                        device=device)
        summary["bridge"] = out["bridge"]["bridge"].loocv_metrics
        out["lite"] = pipelines.run_lite_training(cfg, export=export,
                                                  device=device)
        summary["lite"] = out["lite"]["lite"].summary
    elif args.pipeline == "eeg":
        out = pipelines.run_eeg_experiment(cfg, export=export,
                                           aot_dir=args.aot_dir, device=device)
        summary = {m: r.summary for m, r in out["kfold"].items()}
    elif args.pipeline == "fmri":
        out = pipelines.run_fmri_experiment(cfg, export=export,
                                            aot_dir=args.aot_dir,
                                            device=device)
        summary = {m: r.summary for m, r in out["classification"].items()}
    elif args.pipeline == "bridge":
        out = pipelines.run_bridge_experiment(cfg, export=export,
                                              device=device)
        summary = out["bridge"].loocv_metrics
    else:
        out = pipelines.run_lite_training(cfg, export=export, device=device)
        summary = out["lite"].summary

    print(json.dumps({"pipeline": args.pipeline, "summary": summary},
                     default=str, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
