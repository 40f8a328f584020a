"""Config dataclasses — the port's own copy of ``mmbidaf_tpu.config``, field
for field and default for default, so one config JSON drives either package
(``tests/test_torch_train.py`` checks that the two stay equal).


Every flag the reference's ``args.py`` exposes (hidden_size, drop_prob,
batch_size, num_epochs, ema_decay, max_grad_norm, seed, metric_name, paths …)
has an equivalent field here so experiments translate 1:1. Values follow the
CS224N-starter lineage defaults documented in SURVEY.md §3.1 / §9.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (SURVEY.md §3.1, §9).

    TPU note: ``hidden_size`` defaults to 128 (MXU lane-aligned); set 100 to
    mirror the starter default when doing parity runs against the torch
    oracle (any value works — parity tests use odd sizes on purpose).
    """

    hidden_size: int = 128
    emb_dim: int = 300            # GloVe dimensionality
    img_feat_dim: int = 4096      # VGG fc-layer feature size (SURVEY §3.1)
    audio_feat_dim: int = 40      # n_mfcc / n_mels per frame
    num_highway_layers: int = 2
    # Stacked BiLSTM depth for every encoder tower (word/sentence/image/
    # audio/modeling) — the reference RNNEncoder's ``num_layers`` knob.
    # 1 (the reference's actual setting) keeps the flat params pytree;
    # deeper stacks nest per-layer params ({"layers": [...]}).
    num_rnn_layers: int = 1
    drop_prob: float = 0.2
    # Decoder
    max_decode_steps: int = 4     # K sentences selected per summary
    mask_selected: bool = True    # mask already-picked sentences (SURVEY §8 R4)
    # Fusion: "concat_linear_bilstm" (default, SURVEY §3.1 trimodal wiring)
    fusion: str = "concat_linear_bilstm"
    # Which towers are active — the five graded configs [B:6-12].
    use_images: bool = True
    use_audio: bool = True
    # VGG frontend variant ("vgg16" | "vgg19" | "tiny",
    # ops/vgg.spec_for_variant) — persisted with the run so serving can
    # rebuild the exact frontend without a CLI flag.
    vgg_variant: str = "vgg16"
    # Compute dtype for the accelerated path; params stay fp32.
    compute_dtype: str = "float32"
    # Fused Pallas kernels (behind flags, SURVEY §8 phase 6): inference
    # kernels on the rng-free path, custom-VJP kernels (fused attention
    # backward incl. dropout via similarity-only operands; LSTM BPTT) on
    # the training path — 2.74x measured step throughput (BASELINE.md).
    use_pallas_attention: bool = False
    use_pallas_lstm: bool = False
    use_pallas_melspec: bool = False
    # Winograd F(2x2,3x3) for the VGG conv stack (2.25x fewer MACs than the
    # direct conv XLA emits; ~1e-2 rel. error in bf16 — ops/winograd.py).
    # Off by default: exact-parity runs use the XLA conv.
    use_winograd_conv: bool = False
    # Process the flattened [B*T_img] keyframe axis through resize+VGG in
    # sequential chunks of this many frames. The early conv layers hold
    # ~6.4 MB/frame of activations at 224² bf16 (two live buffers ≈ 13 GB
    # at 1024 frames) — chunking caps peak HBM at ~2×chunk×6.4 MB so large
    # serving batches fit the 16 GB chip. 0 = AUTO: single pass unless the
    # estimated footprint exceeds the safe budget (data/frontend.py), then
    # the largest fitting chunk — oversized batches run instead of OOMing.
    # The frames are independent, so chunking only reorders XLA fusion
    # (~1e-6 fp noise); it serializes the (compute-bound) conv stack.
    # Measured (round 3): B=128 chunked = 302.9 v/s vs B=64 single-pass
    # 304.3 — chunking is a fit-the-chip knob, not a throughput win.
    vgg_frame_chunk: int = 0


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Static bucket shapes (XLA hates ragged — SURVEY.md §8 ground rules)."""

    max_sentences: int = 64       # T_sent bucket
    max_words: int = 32           # W bucket (words per sentence)
    max_keyframes: int = 64       # T_img bucket
    max_audio_frames: int = 512   # T_aud bucket (mel/MFCC frames)
    vocab_size: int = 50000
    # Audio frontend (device-side preprocessing stage, SURVEY §2 L1)
    sample_rate: int = 16000
    n_fft: int = 512
    hop_length: int = 160
    win_length: int = 400
    n_mels: int = 64
    n_mfcc: int = 40
    # "mfcc" (reference lineage, audio_feat_dim == n_mfcc) or "logmel"
    # (audio_feat_dim == n_mels; ~50x smaller dynamic range — raw MFCC c0
    # reaches ~600 and saturates the audio BiLSTM's gates, see
    # docs/QUALITY.md ablation notes)
    audio_features: str = "mfcc"
    # "matmul" (3 GEMMs on the MXU, bf16-input precision ~2-4e-3 on chip)
    # or "stockham" (radix-2 FFT on the VPU, true f32 ~3e-7 — the
    # accuracy-first choice; requires power-of-two n_fft). Speed A/B:
    # experiments/fft_ab.py / docs/KERNELS.md.
    audio_fft: str = "matmul"
    fmin: float = 0.0
    fmax: float | None = None     # None → sample_rate / 2
    # Image frontend
    image_size: int = 224
    # Keyframe sampling policy: "every_n" (uniform) or "shot_change"
    # (largest frame-difference peaks) — SURVEY §3.1 names both.
    keyframe_policy: str = "every_n"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop knobs (SURVEY.md §3.1 "Train driver")."""

    batch_size: int = 32
    num_epochs: int = 30
    lr: float = 0.5
    optimizer: str = "adadelta"   # starter lineage default; "adam" supported
    # LR schedule (reference train driver has an LR scheduler slot):
    # "constant" | "cosine" | "exponential"; warmup applies to all of them.
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    decay_steps: int = 100_000    # horizon for cosine/exponential
    lr_min_ratio: float = 0.01    # floor as a fraction of peak lr
    max_grad_norm: float = 5.0
    # >1: split each batch into this many microbatches inside the jitted
    # step, summing unnormalized NLL grads and dividing by the total valid
    # count once — exactly the full-batch gradient at ~1/accum the peak
    # activation memory (must divide batch_size).
    grad_accum_steps: int = 1
    # Run clip+decay+optimizer math on ONE raveled vector of the trainable
    # leaves instead of per-leaf tree_maps (~340 sub-millisecond fusions for
    # the 56-leaf model shrink to a handful of full-width passes). Same
    # numerics modulo fp reassociation in the global norm. Changes the
    # opt_state layout: resuming a run saved with the other setting needs a
    # matching `{"train": {"flat_updates": ...}}` overlay (docs/OPERATIONS.md).
    flat_updates: bool = True
    # Rematerialize the encoder towers in the backward pass
    # (``jax.checkpoint``): activations of the word/sentence/image/audio
    # towers are dropped after the forward and recomputed during backprop —
    # the canonical FLOPs-for-HBM trade for bigger batches / longer
    # buckets. Same math, exact to fp-reassociation noise (XLA fuses the
    # recomputed forward differently); composes with grad_accum_steps
    # (accum slices the batch, remat slims each microbatch's live set).
    remat_towers: bool = False
    ema_decay: float = 0.999
    l2_wd: float = 0.0
    eval_steps: int = 500
    seed: int = 224
    metric_name: str = "ROUGE-L"
    # None → inferred from metric_name (loss minimizes, ROUGE maximizes);
    # set explicitly for custom metrics.
    maximize_metric: bool | None = None
    max_checkpoints: int = 5
    save_dir: str = "./runs"
    name: str = "mmbidaf"
    load_path: str | None = None


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout (SURVEY.md §3.3). DCN-aware but single-host now."""

    data_axis: str = "data"
    num_data: int = -1            # -1 → remaining local devices
    dcn_axis: str = "dcn"
    num_dcn: int = 1              # multi-host is a config change, not a rewrite
    # Sequence parallelism for the audio tower (SURVEY §3.3 "SP/CP" row:
    # "YES as an option for the audio FFT stage"). num_seq > 1 adds a 'seq'
    # mesh axis; sp_audio routes the audio tower through the sharded chain
    # SP-MFCC → SP-BiLSTM → ring-BiDAF (parallel/sp_tower.py) with the frame
    # axis sharded over 'seq' and never gathered. Batch stays sharded over
    # 'data', so DP x SP composes ((num_dcn x) num_data x num_seq devices).
    # Dtype: the SP frontend + ring attention compute in f32 internally
    # (DFT and softmax-stat numerics); under compute_dtype=bfloat16 the
    # operands are cast at the stage boundaries.
    seq_axis: str = "seq"
    num_seq: int = 1
    sp_audio: bool = False
    # Tensor parallelism for the VGG classifier (SURVEY §3.3 TP row,
    # delivered as an option): num_model > 1 adds an innermost 'model'
    # mesh axis; tp_vgg shards fc1 column-parallel / fc2 row-parallel over
    # it (parallel/mesh.py::shard_frontend) — per-chip classifier weight
    # memory and weight-streaming traffic drop num_model×. The towers
    # (~10M params) stay replicated. Composes with DP (and sp_audio):
    # devices split as (dcn ×) data (× seq) × model.
    model_axis: str = "model"
    num_model: int = 1
    tp_vgg: bool = False


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


def _overlay(dc: Any, overrides: Mapping[str, Any]) -> Any:
    """Return a copy of dataclass ``dc`` with ``overrides`` applied."""
    field_names = {f.name for f in dataclasses.fields(dc)}
    unknown = set(overrides) - field_names
    if unknown:
        raise ValueError(f"unknown config fields for {type(dc).__name__}: {sorted(unknown)}")
    return dataclasses.replace(dc, **dict(overrides))


def config_from_dict(d: Mapping[str, Any]) -> Config:
    """Build a full Config from a (possibly partial) nested dict."""
    cfg = Config()
    return Config(
        model=_overlay(cfg.model, d.get("model", {})),
        data=_overlay(cfg.data, d.get("data", {})),
        train=_overlay(cfg.train, d.get("train", {})),
        mesh=_overlay(cfg.mesh, d.get("mesh", {})),
    )


def config_from_json(path: str) -> Config:
    with open(path) as f:
        return config_from_dict(json.load(f))


def config_to_dict(cfg: Config) -> dict:
    return dataclasses.asdict(cfg)


def tiny_test_config(
    hidden_size: int = 16,
    use_images: bool = True,
    use_audio: bool = True,
) -> Config:
    """A small config for unit tests / smoke runs (odd sizes stress masking)."""
    return Config(
        model=ModelConfig(
            hidden_size=hidden_size,
            emb_dim=24,
            img_feat_dim=20,
            audio_feat_dim=12,
            drop_prob=0.0,
            max_decode_steps=3,
            use_images=use_images,
            use_audio=use_audio,
        ),
        data=DataConfig(
            max_sentences=7,
            max_words=9,
            max_keyframes=6,
            max_audio_frames=11,
            vocab_size=97,
            n_fft=64,
            hop_length=16,
            win_length=48,
            n_mels=12,
            n_mfcc=8,
            image_size=32,
        ),
        train=TrainConfig(batch_size=4, eval_steps=5),
    )
