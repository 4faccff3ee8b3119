"""Top-level experiment pipelines (PyTorch port), the executable-script
layer. Counterpart of ``multimodal_eeg_fmri_tpu/pipelines.py``:

- ``run_eeg_experiment``   ← the EEG notebook's experiment cells
  (``CrossModal_EEG_scr.ipynb §38-44``): 4 models × 5-fold SGKF + LOSO +
  stats + late fusion + exports.
- ``run_fmri_experiment``  ← ``python run_fmri_v11.py``
  (``fMRI_CODE/run_fmri_v11.py:935-1026``): 3 models × stratified 5-fold,
  classification AND regression, exports.
- ``run_bridge_experiment`` ← ``python _test_bridge.py``: two-stage frozen
  extraction + LOOCV + XAI + exports.
- ``run_lite_training``    ← ``python EEG_CODE/run_training_lite.py``
  (BASELINE config #1).

Each builds the JAX package's models with the same widths, dropouts and
defaults, runs the same splits, normalization, augmentation, reports and
exports, and returns the same result dict. The port's models take their
input widths at construction (flax infers them), so each pipeline reads
them from the data. Each runs on ``device``, the card unless the caller
asks for the CPU; without a card the default raises. Each enables the
kernel cache (``core.cache.enable_compilation_cache``) where the JAX
package enables XLA's. ``mesh_plan`` and ``aot_dir`` go on to ``run_cv``:
a plan shards the folds over the mesh's ensemble axis (every rank runs the
pipeline; ``parallel.build_mesh``), and ``aot_dir`` keeps each model's
evaluation program there as a ``core.aot`` bundle.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from multimodal_eeg_fmri_tpu_torch.core.cache import enable_compilation_cache
from multimodal_eeg_fmri_tpu_torch.core.config import ExperimentConfig
from multimodal_eeg_fmri_tpu_torch.core.logging import get_logger
from multimodal_eeg_fmri_tpu_torch.core.rng import seed_everything
from multimodal_eeg_fmri_tpu_torch.data.arrays import model_device
from multimodal_eeg_fmri_tpu_torch.data.synthetic import (
    synthetic_eeg_trimodal,
    synthetic_fmri,
)
from multimodal_eeg_fmri_tpu_torch.models import (
    ERPOnlyNet,
    FMRIActivationOnly,
    FMRIConnectivityOnly,
    FMRIFusionNet,
    PWOnlyNet,
    SmartFusionNetV4,
    TriModalFusionNetV4,
    TriModalFusionNetV4Lite,
)
from multimodal_eeg_fmri_tpu_torch.ops.augment import make_eeg_augment
from multimodal_eeg_fmri_tpu_torch.train.cv import (
    eeg_kfold_splits,
    fmri_kfold_splits,
    loso_splits,
    run_cv,
    run_model_suite,
    subject_level_votes,
)

logger = get_logger()


def _maybe_export(results: Dict[str, Any], cfg: ExperimentConfig,
                  prefix: str, export: bool):
    if not export:
        return {}
    from multimodal_eeg_fmri_tpu_torch.report.export import export_cv_results

    return export_cv_results(results, cfg.output_dir, prefix=prefix)


def _eeg_widths(data: Dict[str, np.ndarray]) -> Dict[str, int]:
    """The input widths the EEG models take from ``data``."""
    return dict(erp_channels=int(data["erp"].shape[-1]),
                pw_channels=int(data["pw"].shape[-1]))


def _fmri_widths(data: Dict[str, np.ndarray]) -> Dict[str, int]:
    return dict(activation_features=int(data["activation"].shape[-1]),
                connectivity_features=int(data["connectivity"].shape[-1]))


def _conn_features(data: Dict[str, np.ndarray]) -> int:
    return int(np.prod(data["conn"].shape[1:]))


def load_or_synthesize_eeg(cfg: ExperimentConfig) -> Dict[str, np.ndarray]:
    """Real files when the data root exists, synthetic fixture otherwise."""
    root = Path(cfg.eeg.data_root)
    if (root / "medical_score.csv").exists():
        from multimodal_eeg_fmri_tpu_torch.data.handler import (
            build_trimodal_arrays,
        )
        from multimodal_eeg_fmri_tpu_torch.data.loaders import (
            load_eeg_conn_features,
            load_eeg_erp_features,
            load_eeg_labels,
            load_eeg_pw_features,
        )

        labels = load_eeg_labels(root)
        subjects = sorted(labels)
        bands = {b: b.capitalize() for b in cfg.eeg.freq_bands}
        freqs = [f"{int(lo)}_{int(hi)}_Hz"
                 for lo, hi in cfg.eeg.freq_bands.values()]
        erp = load_eeg_erp_features(root / "erp", subjects, list(bands),
                                    freqs)
        pw = load_eeg_pw_features(root / "pw", subjects, list(bands), freqs)
        conn = load_eeg_conn_features(root / "conn", subjects, bands,
                                      ["open", "close"])
        return build_trimodal_arrays(
            erp, pw, conn, labels,
            erp_channels=cfg.eeg.erp_channels,
            pw_channels=cfg.eeg.pw_channels,
            conn_dim=cfg.eeg.conn_features,
            time_steps=cfg.eeg.time_steps,
            aggregate=cfg.eeg.aggregate,
        )
    logger.warning("EEG data root %s not found — using synthetic data", root)
    return synthetic_eeg_trimodal(
        n_subjects=66,
        erp_channels=cfg.eeg.erp_channels,
        pw_channels=cfg.eeg.pw_channels,
        conn_features=cfg.eeg.conn_features,
        time_steps=cfg.eeg.time_steps,
        seed=cfg.train.seed,
    )


def load_or_synthesize_fmri(cfg: ExperimentConfig) -> Dict[str, np.ndarray]:
    root = Path(cfg.fmri.data_root)
    if (root / f"sub-{cfg.fmri.subjects[0]}").exists():
        from multimodal_eeg_fmri_tpu_torch.data.handler import (
            build_fmri_arrays,
        )
        from multimodal_eeg_fmri_tpu_torch.data.loaders import (
            load_fmri_activation_features,
            load_fmri_connectivity_features,
            load_fmri_labels,
        )

        act = load_fmri_activation_features(
            root, cfg.fmri.subjects, cfg.fmri.activation_types,
            cfg.fmri.agg_method)
        conn = load_fmri_connectivity_features(
            root, cfg.fmri.subjects, cfg.fmri.connectivity_types)
        cls, reg = load_fmri_labels(root / "DATA" / "labels",
                                    cfg.fmri.subjects)
        return build_fmri_arrays(act, conn, cls, reg)
    logger.warning("fMRI data root %s not found — using synthetic data", root)
    return synthetic_fmri(n_subjects=len(cfg.fmri.subjects),
                          seed=cfg.train.seed)


def eeg_models(cfg: ExperimentConfig, data: Dict[str, np.ndarray],
               device="cuda") -> Dict[str, Any]:
    """The four models of the EEG comparison, as the JAX package's
    ``run_eeg_experiment`` builds them from ``cfg.eeg``: SmartFusionNetV4,
    PWOnlyNet and ERPOnlyNet keep their own dropout defaults."""
    e, w = cfg.eeg, _eeg_widths(data)
    return {
        "trimodal": TriModalFusionNetV4(
            hidden_dim=e.hidden_dim, dropout=e.dropout,
            num_transformer_layers=e.num_transformer_layers,
            num_heads=e.num_heads, num_experts=e.num_experts,
            moe_top_k=e.moe_top_k, conn_features=_conn_features(data),
            device=device, **w),
        "fusion": SmartFusionNetV4(
            hidden_dim=e.hidden_dim,
            num_transformer_layers=e.num_transformer_layers,
            num_heads=e.num_heads, device=device, **w),
        "pwonly": PWOnlyNet(hidden_dim=e.hidden_dim // 2,
                            pw_channels=w["pw_channels"], device=device),
        "erponly": ERPOnlyNet(hidden_dim=e.hidden_dim // 2,
                              erp_channels=w["erp_channels"], device=device),
    }


def run_eeg_experiment(
    cfg: Optional[ExperimentConfig] = None,
    data: Optional[Dict[str, np.ndarray]] = None,
    with_loso: bool = True,
    export: bool = True,
    mesh_plan=None,
    aot_dir: Optional[str] = None,
    device="cuda",
) -> Dict[str, Any]:
    """4-model EEG comparison over subject-grouped stratified 5-fold CV,
    plus LOSO subject voting, stats and late fusion, on ``device``."""
    cfg = cfg or ExperimentConfig()
    enable_compilation_cache()
    dev = model_device(device)
    seed_everything(cfg.train.seed)
    data = data if data is not None else load_or_synthesize_eeg(cfg)

    e = cfg.eeg
    models = eeg_models(cfg, data, dev)
    splits = eeg_kfold_splits(data, cfg.train, n_splits=e.n_splits)
    augment = make_eeg_augment(
        noise_std=e.augment_noise_std,
        channel_dropout=e.augment_channel_dropout, prob=e.augment_prob)
    results = run_model_suite(
        models, cfg.train, data, splits,
        normalize_keys=("erp", "pw", "conn"), augment=augment,
        mesh_plan=mesh_plan, aot_dir=aot_dir,
    )
    for name, r in results.items():
        logger.info("%s: %s", name,
                    {k: f"{m:.4f}±{s:.4f}" for k, (m, s) in r.summary.items()})

    out: Dict[str, Any] = {"kfold": results}
    from multimodal_eeg_fmri_tpu_torch.report.stats import (
        compare_models,
        evaluate_late_fusion,
    )

    out["stats"] = compare_models(results, "f1")
    out["late_fusion"] = evaluate_late_fusion(
        results, ["trimodal", "fusion"], device=dev)

    # deployment-readiness report: per-fold calibration / operating point /
    # leave-one-fold-out conformal coverage (report/clinical.py)
    from multimodal_eeg_fmri_tpu_torch.report.clinical import clinical_report

    out["clinical"] = {name: clinical_report(r, device=dev)
                       for name, r in results.items()}
    for name, rep in out["clinical"].items():
        logger.info("%s clinical: %s", name,
                    {k: f"{m:.3f}±{s:.3f}"
                     for k, (m, s) in rep["summary"].items()})

    if with_loso:
        loso = run_cv(models["trimodal"], cfg.train, data,
                      loso_splits(data, cfg.train),
                      normalize_keys=("erp", "pw", "conn"), augment=augment,
                      mesh_plan=mesh_plan, aot_dir=aot_dir)
        votes = subject_level_votes(loso)
        labels = {int(s): int(l) for s, l in zip(data["subject"],
                                                 data["label"])}
        acc = float(np.mean([votes[s] == labels[s] for s in votes]))
        out["loso"] = {"votes": votes, "subject_accuracy": acc,
                       "result": loso}
        logger.info("LOSO subject-level accuracy: %.4f", acc)

    out["export_paths"] = _maybe_export(results, cfg, "eeg", export)
    return out


def fmri_models(cfg: ExperimentConfig, data: Dict[str, np.ndarray],
                task: str = "classification",
                device="cuda") -> Dict[str, Any]:
    """The three models of the fMRI comparison, as the JAX package's
    ``run_fmri_experiment`` builds them from ``cfg.fmri``."""
    f, w = cfg.fmri, _fmri_widths(data)
    common = dict(hidden_dim=f.hidden_dim, dropout=f.dropout, task=task,
                  device=device)
    return {
        "fusion": FMRIFusionNet(**common, **w),
        "activation_only": FMRIActivationOnly(
            activation_features=w["activation_features"], **common),
        "connectivity_only": FMRIConnectivityOnly(
            connectivity_features=w["connectivity_features"], **common),
    }


def run_fmri_experiment(
    cfg: Optional[ExperimentConfig] = None,
    data: Optional[Dict[str, np.ndarray]] = None,
    export: bool = True,
    with_loso: bool = False,
    mesh_plan=None,
    aot_dir: Optional[str] = None,
    device="cuda",
) -> Dict[str, Any]:
    """3-model fMRI comparison: classification + (when labels exist)
    regression, leakage-free val split protocol. ``with_loso`` adds the
    leave-one-subject-out evaluation (reference
    ``run_fmri_loso_evaluation``, ``CrossModal_fmri_scr.ipynb §12``)."""
    cfg = cfg or ExperimentConfig()
    enable_compilation_cache()
    dev = model_device(device)
    seed_everything(cfg.train.seed)
    data = data if data is not None else load_or_synthesize_fmri(cfg)
    f = cfg.fmri

    cls_data = {k: v for k, v in data.items() if k != "reg_label"}
    models = fmri_models(cfg, cls_data, device=dev)
    splits = fmri_kfold_splits(cls_data, cfg.train, n_splits=f.n_splits)
    results = run_model_suite(
        models, cfg.train, cls_data, splits,
        normalize="feature", normalize_keys=("activation", "connectivity"),
        mesh_plan=mesh_plan, aot_dir=aot_dir,
    )
    out: Dict[str, Any] = {"classification": results}
    for name, r in results.items():
        logger.info("fMRI %s: %s", name,
                    {k: f"{m:.4f}±{s:.4f}" for k, (m, s) in r.summary.items()})

    from multimodal_eeg_fmri_tpu_torch.report.clinical import clinical_report

    out["clinical"] = {name: clinical_report(r, device=dev)
                       for name, r in results.items()}

    if "reg_label" in data:
        reg_data = dict(data)
        reg_data["label"] = data["reg_label"].astype(np.float32)
        reg_data.pop("reg_label")
        reg_models = fmri_models(cfg, cls_data, task="regression",
                                 device=dev)
        reg_splits = fmri_kfold_splits(cls_data, cfg.train,
                                       n_splits=f.n_splits)
        out["regression"] = run_model_suite(
            reg_models, cfg.train, reg_data, reg_splits,
            task="regression", normalize="feature",
            normalize_keys=("activation", "connectivity"),
            mesh_plan=mesh_plan, aot_dir=aot_dir,
        )
        for name, r in out["regression"].items():
            logger.info("fMRI regression %s: %s", name,
                        {k: f"{m:.4f}" for k, (m, _) in r.summary.items()})

    if with_loso:
        loso = run_cv(models["fusion"], cfg.train, cls_data,
                      loso_splits(cls_data, cfg.train),
                      normalize="feature",
                      normalize_keys=("activation", "connectivity"),
                      mesh_plan=mesh_plan, aot_dir=aot_dir)
        votes = subject_level_votes(loso)
        labels = {int(s): int(l) for s, l in zip(cls_data["subject"],
                                                 cls_data["label"])}
        acc = float(np.mean([votes[s] == labels[s] for s in votes]))
        out["loso"] = {"votes": votes, "subject_accuracy": acc,
                       "result": loso}
        logger.info("fMRI LOSO subject-level accuracy: %.4f", acc)

    out["export_paths"] = _maybe_export(results, cfg, "fmri", export)
    return out


def bridge_stage1_models(cfg: ExperimentConfig, eeg_data, fmri_data,
                         device="cuda") -> tuple:
    """The stage-1 encoders of the bridge, as the JAX package's
    ``run_bridge_experiment`` builds them: TriModalFusionNetV4 from
    ``cfg.eeg`` (without MoE) and FMRIFusionNet from ``cfg.fmri``."""
    e = cfg.eeg
    eeg_model = TriModalFusionNetV4(
        hidden_dim=e.hidden_dim, dropout=e.dropout,
        num_transformer_layers=e.num_transformer_layers,
        num_heads=e.num_heads, conn_features=_conn_features(eeg_data),
        device=device, **_eeg_widths(eeg_data))
    fmri_model = FMRIFusionNet(hidden_dim=cfg.fmri.hidden_dim,
                               dropout=cfg.fmri.dropout, device=device,
                               **_fmri_widths(fmri_data))
    return eeg_model, fmri_model


def run_bridge_experiment(
    cfg: Optional[ExperimentConfig] = None,
    eeg_data: Optional[Dict[str, np.ndarray]] = None,
    fmri_data: Optional[Dict[str, np.ndarray]] = None,
    export: bool = True,
    device="cuda",
) -> Dict[str, Any]:
    """Full two-stage bridge: train stage-1 encoders, freeze + extract,
    LOOCV bridge with XAI, exports, on ``device``.

    Stage 1 trains each encoder once on all subjects from the streams of
    ``cfg.train.seed`` (``train/cv.py``'s ``fold_rngs``: the counterpart of
    the JAX package's ``fit`` from ``key(seed)``)."""
    from multimodal_eeg_fmri_tpu_torch.data.arrays import pad_rows
    from multimodal_eeg_fmri_tpu_torch.train.bridge_flow import (
        align_bridge_dataset,
        extract_fused_features,
        run_bridge_loocv,
    )
    from multimodal_eeg_fmri_tpu_torch.train.cv import (
        fold_rngs,
        start_fold,
    )
    from multimodal_eeg_fmri_tpu_torch.train.fit import make_fit_fn

    cfg = cfg or ExperimentConfig()
    enable_compilation_cache()
    dev = model_device(device)
    seed_everything(cfg.train.seed)
    eeg_data = (eeg_data if eeg_data is not None
                else load_or_synthesize_eeg(cfg))
    fmri_data = (fmri_data if fmri_data is not None
                 else load_or_synthesize_fmri(cfg))
    fmri_cls = {k: v for k, v in fmri_data.items() if k != "reg_label"}
    labels = {int(s): int(l) for s, l in zip(eeg_data["subject"],
                                             eeg_data["label"])}

    # stage-1 trains on ALL subjects with no held-out split (the reference's
    # _test_bridge.py trains the encoders on the full set before freezing),
    # so model selection must be train-loss based: eval_names=() rejects the
    # default selection="val".
    stage1_cfg = dataclasses.replace(cfg.train, selection="train_loss")

    def _stage1(model, data):
        n = len(data["label"])
        train = pad_rows({k: v for k, v in data.items() if k != "subject"}, n)
        rngs = fold_rngs(stage1_cfg.seed, dev)
        start_fold(model, rngs)
        fit = make_fit_fn(model, stage1_cfg, eval_names=())
        return fit(rngs.shuffle, train, {}, None)

    eeg_model, fmri_model = bridge_stage1_models(cfg, eeg_data, fmri_cls,
                                                 dev)
    eeg_res = _stage1(eeg_model, eeg_data)
    fmri_res = _stage1(fmri_model, fmri_cls)

    eeg_subj, eeg_feats = extract_fused_features(
        eeg_model, eeg_res.params, eeg_res.batch_stats, eeg_data)
    fmri_subj, fmri_feats = extract_fused_features(
        fmri_model, fmri_res.params, fmri_res.batch_stats, fmri_cls)
    bridge_data = align_bridge_dataset(eeg_subj, eeg_feats, fmri_subj,
                                       fmri_feats, labels)
    logger.info("bridge: %d aligned subjects", len(bridge_data["label"]))

    bridge_cfg = dataclasses.replace(
        cfg.train, selection="train_loss",
        learning_rate=1e-4, weight_decay=1e-4)
    res = run_bridge_loocv(bridge_data, bridge_cfg,
                           bridge_dim=cfg.bridge.bridge_dim,
                           num_heads=cfg.bridge.num_heads,
                           dropout=cfg.bridge.dropout, device=dev)
    logger.info("bridge LOOCV: %s",
                {k: f"{v:.4f}" for k, v in res.loocv_metrics.items()})
    logger.info("bridge clinical (pooled, LOO conformal): %s",
                {k: f"{v:.3f}" for k, v in res.clinical.items()})

    if export:
        from multimodal_eeg_fmri_tpu_torch.report.export import (
            export_per_subject_records,
            export_xai_arrays,
        )

        export_xai_arrays(res.xai, cfg.output_dir, prefix="bridge_xai")
        export_per_subject_records(res.per_subject, cfg.output_dir,
                                   prefix="bridge_subjects")
    return {"bridge": res, "bridge_data": bridge_data}


def lite_model(cfg: ExperimentConfig, data: Dict[str, np.ndarray],
               device="cuda") -> TriModalFusionNetV4Lite:
    """V4-Lite as the JAX package's ``run_lite_training`` builds it."""
    return TriModalFusionNetV4Lite(
        hidden_dim=cfg.eeg.lite_hidden_dim, dropout=cfg.eeg.lite_dropout,
        conn_features=_conn_features(data), device=device,
        **_eeg_widths(data))


def run_lite_training(
    cfg: Optional[ExperimentConfig] = None,
    data: Optional[Dict[str, np.ndarray]] = None,
    export: bool = True,
    device="cuda",
) -> Dict[str, Any]:
    """The lite k-fold loop (BASELINE config #1): V4-Lite tri-modal,
    label-smoothing CE + warmup-cosine + early stopping, on ``device``."""
    cfg = cfg or ExperimentConfig()
    enable_compilation_cache()
    dev = model_device(device)
    seed_everything(cfg.train.seed)
    data = data if data is not None else load_or_synthesize_eeg(cfg)
    lite_cfg = dataclasses.replace(
        cfg.train, loss="label_smoothing", schedule="warmup_cosine",
        weight_decay=0.01, patience=15, selection="val")
    model = lite_model(cfg, data, dev)
    splits = eeg_kfold_splits(data, lite_cfg, n_splits=cfg.eeg.n_splits)
    result = run_cv(model, lite_cfg, data, splits,
                    normalize_keys=("erp", "pw", "conn"),
                    augment=make_eeg_augment())
    logger.info("lite: %s",
                {k: f"{m:.4f}±{s:.4f}" for k, (m, s) in result.summary.items()})
    out = {"lite": result}
    out["export_paths"] = _maybe_export({"trimodal_lite": result}, cfg,
                                        "lite", export)
    return out
