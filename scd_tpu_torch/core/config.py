"""Configuration tree for the PyTorch pipeline.

A field-for-field copy of the JAX package's tree (``scd_tpu/core/config.py``):
equal configs give equal :func:`config_hash` values in both packages, so
both derive the same artifact-cache keys and each re-enters the other's
caches.  Every knob and every filesystem location lives in one typed
dataclass tree; a stable hash of the tree keys the artifact cache.

Some fields steer code the port does not have yet (the ``model`` mesh
axis, tensor parallelism); they stay so that the hashes agree.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple


def _asdict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: _asdict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_asdict(x) for x in obj]
    if isinstance(obj, dict):
        return {str(k): _asdict(v) for k, v in obj.items()}
    return obj


def config_hash(cfg: Any, extra: Optional[dict] = None) -> str:
    """Deterministic short hash of a config dataclass (cache keying)."""
    payload = _asdict(cfg)
    if extra:
        payload = {"cfg": payload, "extra": extra}
    blob = json.dumps(payload, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout (``core/mesh.py``: one rank per device; a
    ``model`` axis above 1 reaches only the vocabulary top-k).

    ``data`` shards the instance axis (images / feature rows); ``model``
    shards wide axes (vocabulary columns, MLP hidden, attention heads).
    """

    data: int = -1  # -1: use all devices on the data axis
    model: int = 1
    axis_names: Tuple[str, str] = ("data", "model")


@dataclass(frozen=True)
class ClusterConfig:
    """Clustering stage config (reference ``main_unsup.py:216-220, 339-362``)."""

    algorithm: str = "KM"  # KM | SSKM | ConSSKM | FINCH
    n_clusters: int = 100
    tolerance: float = 1e-4
    max_iterations: int = 10  # the mains use 10 (main_unsup.py:339,350)
    n_init: int = 10
    init: str = "k-means++"  # k-means++ | random
    size_min: int = 50  # ConSSKM only (main_unsup.py:219)
    size_max: int = 1200  # ConSSKM only (main_unsup.py:220)
    seed: int = 0
    # Constrained E-step backend: "sinkhorn" or "mcf" (ConSSKM only)
    constrained_backend: str = "sinkhorn"
    # k-means++ greedy local trials (vendored-package ``_k_init``):
    # 0 = simple kpp (sskm_constrained.py:28), -1 = auto (2 + int(log k)),
    # >0 = explicit trial count
    kpp_local_trials: int = 0
    sinkhorn_epsilon: float = 0.01
    sinkhorn_iters: int = 200
    # exact-MCF restart thread pool: 0 = auto (min(n_init, 4)), 1 = serial
    mcf_restart_threads: int = 0
    # row chunk of the JAX package's E-step kernel (unused by the port)
    estep_block_rows: int = 1024
    # Fused E+M kernel dispatch: "auto" (the kernel on a CUDA device, the
    # plain version on the CPU), True, False.  The SCD_FUSED_MESH env var
    # overrides when set ("0"/"" = off).  In the port a CUDA tensor always
    # goes to the kernel: "off" on a CUDA device raises.
    fused_mesh: object = "auto"  # "auto" | True | False
    # E-step variant of the fused kernel.  "exact": full-precision x.
    # "x_bf16": x stored as bf16 (halves the bytes the kernel reads).
    # "2pass": a TPU bf16-split variant; on a CUDA device the cross term
    # is f32 either way, so it runs as "exact".  "auto" (default): one
    # probe EM iteration on the actual features compares x_bf16 with exact
    # labels and takes x_bf16 only on agreement up to ties
    # (cluster/kmeans.py::_resolve_estep).  SCD_ESTEP env var overrides.
    estep: str = "auto"  # auto | exact | x_bf16 | 2pass


@dataclass(frozen=True)
class NamingConfig:
    """CLIP vocabulary-voting config (reference ``main_unsup.py:221-224, 568-641``)."""

    corpus: str = "wordnet"  # wordnet | wikibird | wikidog | <path to txt>
    topk: int = 5  # per-image top-k names kept (imagenet 5, sdogs 2, cub 3)
    num_common_vote: int = 20  # candidate pool size per cluster
    num_common_linear: int = 4  # entries per cluster entering the vote matrix
    logit_scale: float = 100.0
    max_vote_iters: int = 50  # safety bound; reference loops until set-fixpoint
    textual_enhancement: bool = False  # 'w/TE' rows of the reference tables
    te_alpha: float = 0.5  # text/image mixing weight for TE


@dataclass(frozen=True)
class DataConfig:
    """Dataset selection and filesystem roots (replaces the reference's
    hardcoded absolute paths, e.g. ``clip_lang_util.py:141-148``)."""

    dataset_name: str = "synthetic"
    root_dir: str = "/data"
    prop_train_labels: float = 0.5
    use_ssb_splits: bool = True
    image_size: int = 224
    crop_pct: float = 0.875
    interpolation: str = "bicubic"
    batch_size: int = 128
    num_workers: int = 2
    # asset locations (all optional; features may be precomputed instead)
    corpus_dir: str = ""  # dir holding wordnet_all_noun.txt etc.
    wordnet_db_dir: str = ""  # WNDB-format dict/ directory (data.noun, index.noun)
    clip_weights: str = ""  # path to OpenAI CLIP ViT-B/16 state dict (.pt / .npz)
    dino_weights: str = ""  # path to DINO ViT-B/16 state dict
    gcd_weights_dir: str = ""  # dir with {dataset}_model_best.pt
    zeroshot_weights: str = ""  # precomputed [D, V] text-embedding matrix
    cache_dir: str = "artifacts"  # artifact cache root


@dataclass(frozen=True)
class FeatureConfig:
    """Which frozen encoder produces clustering features
    (reference ``main_unsup.py:211,240-264``)."""

    # clip | dino_vit | dino_vit_s | dino_vit_t | vit_supervised |
    # resnet50 | gcd (reference extract_features.py:95-187 backbone set)
    feat_model: str = "dino_vit"
    feature_dim: int = 768
    normalize: bool = True
    # W8A8 int8 dense path for the ViT extraction towers; off by default
    dense_int8: bool = False
    # tanh-approx GELU for the DINO-family extraction towers
    gelu_tanh: bool = True


@dataclass(frozen=True)
class TrainConfig:
    """GCD contrastive finetuning (reference ``learn_metric.py:217-338``)."""

    epochs: int = 200
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    sup_con_weight: float = 0.35
    temperature: float = 1.0
    sup_temperature: float = 0.07
    n_views: int = 2
    grad_from_block: int = 11
    batch_size: int = 128
    proj_dim: int = 65536
    seed: int = 1
    # int8-quantize the frozen trunk's dense layers (blocks < grad_from_block)
    int8_frozen: bool = False


@dataclass(frozen=True)
class PipelineConfig:
    """Top-level config for the unsup / ptsup pipelines."""

    mesh: MeshConfig = field(default_factory=MeshConfig)
    data: DataConfig = field(default_factory=DataConfig)
    feature: FeatureConfig = field(default_factory=FeatureConfig)
    cluster: ClusterConfig = field(default_factory=ClusterConfig)
    naming: NamingConfig = field(default_factory=NamingConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    partially_supervised: bool = False
    extract_feat: bool = False
    run_cluster: bool = True
    save_cluster: bool = True
    eval_soft_sacc: bool = True

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def flat_override(cfg: PipelineConfig, dotted: Sequence[str]) -> PipelineConfig:
    """Apply ``section.key=value`` CLI overrides to a PipelineConfig."""
    import ast

    kw: dict = {}
    nested: dict = {}
    for item in dotted:
        path, _, raw = item.partition("=")
        try:
            val = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            # 'false'/'true' must not fall through as truthy strings
            low = raw.strip().lower()
            val = {"true": True, "false": False}.get(low, raw)
        if "." in path:
            sec, _, key = path.partition(".")
            nested.setdefault(sec, {})[key] = val
        else:
            kw[path] = val

    for sec, fields in nested.items():
        if not hasattr(cfg, sec):
            raise KeyError(f"unknown config section {sec!r}")
        kw[sec] = dataclasses.replace(getattr(cfg, sec), **fields)
    return dataclasses.replace(cfg, **kw)
