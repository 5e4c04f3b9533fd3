"""Configuration system: typed dataclasses with JSON round-trip.

The port's own copy of dodt_tpu/config.py, field for field and preset
for preset: the port imports nothing of the JAX package. A config of
either package converts to the other through JSON
(``PipelineConfig.from_json(other.to_json())``; ``convert.config_from_json``),
and tests/test_torch_host_copies.py holds every preset's JSON equal.

Mirrors the field surface of the reference protobuf schema
(avod/protos/*.proto — pipeline, model, layers, kitti_dataset,
kitti_utils, mini_batch, train, eval, optimizer) as plain dataclasses.
The canonical preset reproduces
avod/configs/pyramid_cars_with_aug_dt_5_tracking.config.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------- dataset

@dataclass
class BevSlicesConfig:
    height_lo: float = -0.2
    height_hi: float = 2.3
    num_slices: int = 5


@dataclass
class KittiUtilsConfig:
    # [[x_min, x_max], [y_min, y_max], [z_min, z_max]]
    area_extents: Tuple[Tuple[float, float], ...] = (
        (-40.0, 40.0), (-5.0, 3.0), (0.0, 70.0))
    voxel_size: float = 0.1
    anchor_strides: Tuple[float, float] = (0.5, 0.5)
    density_threshold: int = 1
    bev_generator: BevSlicesConfig = field(default_factory=BevSlicesConfig)

    @property
    def bev_extents(self):
        return [list(self.area_extents[0]), list(self.area_extents[2])]

    @property
    def bev_shape(self) -> Tuple[int, int]:
        """(H, W) of the BEV image (z rows, x cols)."""
        h = int(round((self.area_extents[2][1] - self.area_extents[2][0])
                      / self.voxel_size))
        w = int(round((self.area_extents[0][1] - self.area_extents[0][0])
                      / self.voxel_size))
        return h, w


@dataclass
class MiniBatchConfig:
    rpn_neg_iou_range: Tuple[float, float] = (0.0, 0.3)
    rpn_pos_iou_range: Tuple[float, float] = (0.5, 1.0)
    rpn_mini_batch_size: int = 512
    avod_neg_iou_range: Tuple[float, float] = (0.0, 0.55)
    avod_pos_iou_range: Tuple[float, float] = (0.65, 1.0)
    avod_mini_batch_size: int = 1024


@dataclass
class DatasetConfig:
    name: str = "kitti_tracking"
    dataset_dir: str = "data/kitti/tracking"
    data_split: str = "train"
    data_split_dir: str = "training"
    classes: Tuple[str, ...] = ("Car",)
    num_clusters: Tuple[int, ...] = (2,)
    bev_source: str = "lidar"
    aug_list: Tuple[str, ...] = ("flipping", "pca_jitter")
    data_stride: int = 1            # temporal stride tau between frames
    video_train_ids: Tuple[int, ...] = tuple(range(21))
    kitti_utils: KittiUtilsConfig = field(default_factory=KittiUtilsConfig)
    mini_batch: MiniBatchConfig = field(default_factory=MiniBatchConfig)
    # static capacities (TPU shapes)
    max_points: int = 131072        # padded point-cloud capacity per frame
    max_gt_boxes: int = 32          # padded labels per frame
    image_shape: Tuple[int, int] = (360, 1200)  # (h, w) network input


# ---------------------------------------------------------------- model

@dataclass
class FeatureExtractorConfig:
    """VGG-pyramid tower: [num_convs, channels] per stage."""
    conv1: Tuple[int, int] = (2, 32)
    conv2: Tuple[int, int] = (2, 64)
    conv3: Tuple[int, int] = (3, 128)
    conv4: Tuple[int, int] = (3, 256)
    l2_weight_decay: float = 0.0005
    # decoder output stride: 1 = full-resolution decode (reference
    # bev_vgg_pyramid semantics); 2 = stop one level up — full-res
    # convs are layout-bound on TPU, and only the 1-channel RPN
    # bottleneck needs full resolution (it gets upsampled)
    decode_stride: int = 2
    # False = plain VGG (reference bev_vgg/img_vgg: encoder + bilinear
    # upsample of conv4, no skip decoder)
    pyramid: bool = True
    # "none" matches the reference (plain conv+relu, no normalization)
    # and is ~3x faster on TPU; "gn" adds GroupNorm after every conv
    norm: str = "none"
    # run the full-resolution conv1 block in space-to-depth layout
    # (exact same function, MXU-friendly channel counts); only applies
    # with decode_stride=2, where full-res c1 is never needed
    s2d_stem: bool = True
    # extend the s2d treatment through the tower interior: conv2 block
    # in s2d layout (entry conv fused with the implicit s2d as one
    # stride-2 phase-packed conv), packed subpixel up2 (no
    # depth-to-space), fusion2 conv in s2d layout with one final
    # depth-to-space — exact same function, wider MXU contractions,
    # zero thin-channel relayouts (requires s2d_stem + the same gates)
    s2d_interior: bool = True
    # standard-layout interior blocks to run through the fused Pallas
    # conv-chain kernel (ops/conv_chain.py): whole blocks as
    # VMEM-resident shifted matmuls, one HBM round trip per block
    # instead of per conv. Same parameter tree; XLA twin off-TPU;
    # tolerance-level (last-bit bf16) output difference. Names from
    # {"conv3", "conv4", "pyramid_fusion3"}; measured (r4 probe):
    # the kernel wins only where XLA's conv emitter underperforms at
    # 256-channel MXU shapes — conv4 — and loses at conv3/fusion3
    # (results_r04/tower_bisect.json), so dispatch is per-block.
    fused_interior: Tuple[str, ...] = ("conv4",)
    # row-strip height of the fused kernel (16 measured best at the
    # production conv4 shapes; benchmarks/probe_conv_chain.py)
    fused_tile_rows: int = 16


@dataclass
class CorrelationConfig:
    max_displacement: int = 5
    padding: int = 5
    stride_2: int = 1


@dataclass
class RpnConfig:
    proposal_roi_crop_size: int = 3
    fusion_method: str = "mean"          # mean | concat
    train_nms_size: int = 1024
    test_nms_size: int = 300
    nms_iou_thresh: float = 0.8
    cls_fc_sizes: Tuple[int, int] = (256, 256)
    reg_fc_sizes: Tuple[int, int] = (256, 256)
    corr_fc_sizes: Tuple[int, int] = (256, 256)
    keep_prob: float = 0.5
    bottleneck_channels: int = 1
    # eval-time two-pass fusion: rank anchors by the (dense, gather
    # free) BEV-only head score and fuse image ROIs only for the top-K
    # candidates; 0 = single-pass full fusion (always used in train).
    # Measured (results_r03/kfuse_ab.json): same-checkpoint AP/MOTA are
    # bit-identical for K in {8192..1024}, but the latency delta is
    # only ~0.3 ms (14.62 -> 14.17 ms keyframe) — within run-to-run
    # noise — because the tiny-crop gathers are latency- not
    # volume-bound in K. The default stays 8192: lowering it flips
    # mid-size configs (2048 < anchors < 8192) onto the two-pass path
    # whose candidate outputs cannot feed compute_losses outside the
    # in-forward mini-batch, for no measurable win.
    fusion_top_k: int = 8192


@dataclass
class AvodConfig:
    proposal_roi_crop_size: int = 7
    positive_selection: str = "not_bkg"
    nms_size: int = 100
    nms_iou_thresh: float = 0.01
    box_representation: str = "box_4ca"  # box_3d | box_8c | box_4c | box_4ca
    fc_layer_sizes: Tuple[int, ...] = (2048, 2048, 2048)
    fusion_method: str = "mean"          # mean | concat | max
    fusion_type: str = "early"           # early | late | deep
    keep_prob: float = 0.5
    l2_weight_decay: float = 0.005
    # eval-time windowed Pallas form for the second-stage BEV crops:
    # exact for ROIs spanning <= window-2 px of the stride-2 BEV map
    # (metric bound: cars + expand margin ~ 45 px). 0 = generic path.
    bev_roi_window: int = 64


@dataclass
class LossConfig:
    cls_loss_weight: float = 1.0
    reg_loss_weight: float = 5.0
    ang_loss_weight: float = 1.0
    corr_loss_weight: float = 5.0


@dataclass
class ModelConfig:
    model_name: str = "dt_avod_model"
    checkpoint_name: str = "dodt_tpu_cars"
    rpn: RpnConfig = field(default_factory=RpnConfig)
    avod: AvodConfig = field(default_factory=AvodConfig)
    correlation: CorrelationConfig = field(default_factory=CorrelationConfig)
    bev_extractor: FeatureExtractorConfig = field(
        default_factory=FeatureExtractorConfig)
    img_extractor: FeatureExtractorConfig = field(
        default_factory=FeatureExtractorConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    label_smoothing_epsilon: float = 0.001
    expand_proposals_xz: float = 0.0
    path_drop_probabilities: Tuple[float, float] = (0.9, 0.9)
    train_on_all_samples: bool = False
    eval_all_samples: bool = False
    # compute dtype for the conv towers ("bfloat16" or "float32")
    tower_dtype: str = "bfloat16"
    # rematerialize tower activations in the backward pass
    # (jax.checkpoint on the conv towers). The encoder/decoder's
    # full-res intermediates dominate train-step HBM (421 MB per
    # 128-ch img stage at B=8 couples); storing them OOMs the B=8
    # compile, remat runs it at 1.58 s/step. At B<=4 the two forms are
    # within ~10% (the superlinear per-couple cost there is a
    # forward-pass conv-layout property, not activation storage —
    # results_r03/train_batched.json), so the default stays off for
    # the production B=1 config and batched runs opt in.
    remat_towers: bool = False
    # crop-and-resize VJP form on train paths: "batch_auto" keeps the
    # measured batch-aware dispatch (plain gather/scatter VJP at B=1,
    # the matmul-form scatter-free VJP at B>1 —
    # results_r03/train_fwd_bwd.json); "gather" / "mmbwd" force one
    # form at any batch (profilers A/B the forms at fixed B with this)
    train_crop_vjp: str = "batch_auto"
    # "fast" = parallel one-pass NMS (TPU-friendly, subset of greedy's
    # picks); "greedy" = exact sequential tf.image.non_max_suppression
    # "exact" = parallel fixpoint NMS with exact greedy semantics (the
    # measured fast-vs-greedy gap is ~5 AP_3D moderate on a trained
    # checkpoint — results_r02/fixture_ap.json — so subset-keeping
    # "fast" is opt-in, not the default)
    nms_mode: str = "exact"


# ---------------------------------------------------------------- train/eval

@dataclass
class OptimizerConfig:
    name: str = "adam"
    initial_lr: float = 0.0001
    decay_steps: int = 30000
    decay_factor: float = 0.8
    staircase: bool = True
    grad_clip_norm: float = 1.0
    use_moving_average: bool = False
    moving_average_decay: float = 0.9999


@dataclass
class TrainConfig:
    batch_size: int = 1              # pairs per device
    max_iterations: int = 120000
    checkpoint_interval: int = 1000
    summary_interval: int = 10
    max_checkpoints_to_keep: int = 10000
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    # named-subtree transfer learning (replaces the reference's
    # hard-coded trainable-variable index slices, trainer.py:160-183)
    pretrained_checkpoint: Optional[str] = None
    # None = restore ALL subtrees shared with the source checkpoint;
    # an explicit tuple restores exactly those (raising on a missing
    # name); () = restore nothing. See CheckpointIO.restore_subtrees.
    pretrained_subtrees: Optional[Tuple[str, ...]] = None
    # True = restore the FULL TrainState (params + global step + Adam
    # moments + EMA) from pretrained_checkpoint — the reference's
    # stage-3 re-launch, whose full-saver restore carries global_step so
    # the exp-decay LR continues decayed (trainer.py:156-157)
    pretrained_full_state: bool = False
    frozen_subtrees: Tuple[str, ...] = ()
    # numeric sanitizer: raise at the op producing a NaN (jax_debug_nans)
    debug_nans: bool = False


@dataclass
class EvalConfig:
    eval_interval: int = 1000
    eval_mode: str = "val"
    ckpt_indices: Tuple[int, ...] = ()
    evaluate_repeatedly: bool = True
    eval_wait_interval: int = 30
    kitti_score_threshold: float = 0.1
    # val couples per device dispatch (the reference loops a batch-1
    # feed_dict, dt_evaluator.py:233-365; batching the val loop is
    # nearly-free eval throughput on TPU — the last chunk is padded to
    # keep the jit shape static)
    batch_size: int = 1
    # emit per-checkpoint val losses + RPN proposal recall (reference
    # save_proposal_losses_results, dt_evaluator.py:764-810); costs one
    # extra train-mode jit + one val pass per checkpoint
    val_health: bool = False
    # tracker thresholds (eval.proto:17-20)
    track_lth: float = 0.5
    track_hth: float = 0.85
    track_liou: float = 0.005
    track_tmin: int = 3


@dataclass
class PipelineConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)

    # ------------------------------------------------------------ io
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "PipelineConfig":
        return _from_dict(cls, json.loads(text))

    def save(self, path: str):
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "PipelineConfig":
        with open(path) as f:
            return cls.from_json(f.read())


def _from_dict(cls, data):
    """Recursively build nested dataclasses from dicts."""
    if not dataclasses.is_dataclass(cls):
        return data
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key, value in data.items():
        if key not in fields:
            continue
        f = fields[key]
        ftype = f.type
        if isinstance(ftype, str):
            ftype = eval(ftype)  # dataclass module-level names  # noqa: S307
        if dataclasses.is_dataclass(ftype) and isinstance(value, dict):
            kwargs[key] = _from_dict(ftype, value)
        elif isinstance(value, list):
            kwargs[key] = _to_tuple(value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


def _to_tuple(value):
    if isinstance(value, list):
        return tuple(_to_tuple(v) for v in value)
    return value


# ---------------------------------------------------------------- presets

def cars_dt_tracking(data_stride: int = 1) -> PipelineConfig:
    """Canonical paired-frame tracking config (parity target:
    avod/configs/pyramid_cars_with_aug_dt_5_tracking.config)."""
    cfg = PipelineConfig()
    cfg.dataset.data_stride = data_stride
    return cfg


def cars_single_frame() -> PipelineConfig:
    """Single-frame AVOD config (pyramid_cars_with_aug_example.config)."""
    cfg = PipelineConfig()
    cfg.model.model_name = "avod_model"
    cfg.dataset.name = "kitti"
    return cfg


# The single-frame detector's parameter subtrees (everything except the
# correlation branch, which only exists in the paired model).
DETECTOR_SUBTREES = ("bev_vgg_pyr", "img_vgg_pyr", "bev_bottleneck",
                     "img_bottleneck", "rpn_cls", "rpn_reg", "avod_fc")


def cars_dt_tracking_staged(pretrained_dir: str,
                            data_stride: int = 1) -> PipelineConfig:
    """Stage-2 of the reference's staged training flow
    (trainer.py:64-183): restore the detector subtrees (towers + RPN +
    second-stage head) from a `cars_single_frame` pretrain checkpoint,
    freeze them, and train only the correlation branch
    (bev_corr_bottleneck + corr_fc). The reference encodes the same
    split as brittle trainable-variable index slices ([:68]+[70:94]
    restored & frozen, [68:70]+[94:] trained)."""
    cfg = cars_dt_tracking(data_stride)
    cfg.train.pretrained_checkpoint = pretrained_dir
    cfg.train.pretrained_subtrees = DETECTOR_SUBTREES
    cfg.train.frozen_subtrees = DETECTOR_SUBTREES
    return cfg


def cars_dt_tracking_finetune(staged_dir: str,
                              data_stride: int = 1) -> PipelineConfig:
    """Stage-3 of the staged flow: joint finetune. Restores the FULL
    train state (detector + correlation branch params, global step,
    Adam moments) from the stage-2 staged checkpoint and trains
    everything jointly — the reference runs this by re-launching with
    use_pretrained_model=False, which makes variable_to_train=None
    (all variables, trainer.py:77-82) while the full saver restores the
    previous checkpoint incl. global_step and optimizer slots
    (trainer.py:156-157), so the exp-decay LR schedule continues from
    its decayed position. Training therefore resumes at the staged
    checkpoint's step: pass the TOTAL step budget to train()."""
    cfg = cars_dt_tracking(data_stride)
    cfg.train.pretrained_checkpoint = staged_dir
    cfg.train.pretrained_full_state = True
    cfg.train.frozen_subtrees = ()
    return cfg


def pedestrians_dt_tracking(data_stride: int = 1) -> PipelineConfig:
    """Pedestrian preset (parity target: pyramid_people/pedestrian
    configs + configs/mb_preprocessing/rpn_pedestrians.config: one
    size cluster, tighter mini-batch IoU ranges, smaller area z)."""
    cfg = PipelineConfig()
    cfg.dataset.data_stride = data_stride
    cfg.dataset.classes = ("Pedestrian",)
    cfg.dataset.num_clusters = (1,)
    cfg.dataset.mini_batch.rpn_neg_iou_range = (0.0, 0.3)
    cfg.dataset.mini_batch.rpn_pos_iou_range = (0.45, 1.0)
    cfg.dataset.mini_batch.avod_neg_iou_range = (0.0, 0.45)
    cfg.dataset.mini_batch.avod_pos_iou_range = (0.55, 1.0)
    cfg.model.checkpoint_name = "dodt_tpu_pedestrians"
    return cfg


def cyclists_dt_tracking(data_stride: int = 1) -> PipelineConfig:
    """Cyclist preset (rpn_cyclists.config equivalent)."""
    cfg = pedestrians_dt_tracking(data_stride)
    cfg.dataset.classes = ("Cyclist",)
    cfg.model.checkpoint_name = "dodt_tpu_cyclists"
    return cfg


def people_dt_tracking(data_stride: int = 1) -> PipelineConfig:
    """Joint Pedestrian+Cyclist preset (rpn_people.config
    equivalent): multi-class head with per-class size clusters."""
    cfg = pedestrians_dt_tracking(data_stride)
    cfg.dataset.classes = ("Pedestrian", "Cyclist")
    cfg.dataset.num_clusters = (1, 1)
    cfg.model.checkpoint_name = "dodt_tpu_people"
    return cfg


def unittest_pipeline() -> PipelineConfig:
    """Small config for tests: tiny area, reduced capacities."""
    cfg = PipelineConfig()
    cfg.dataset.kitti_utils.area_extents = (
        (-4.0, 4.0), (-5.0, 3.0), (0.0, 7.0))
    cfg.dataset.max_points = 4096
    cfg.dataset.max_gt_boxes = 8
    cfg.dataset.image_shape = (90, 300)
    cfg.dataset.mini_batch.rpn_mini_batch_size = 64
    cfg.dataset.mini_batch.avod_mini_batch_size = 64
    cfg.model.rpn.train_nms_size = 64
    cfg.model.rpn.test_nms_size = 32
    cfg.model.avod.nms_size = 16
    cfg.model.avod.fc_layer_sizes = (64, 64, 64)
    cfg.model.bev_extractor = FeatureExtractorConfig(
        conv1=(1, 8), conv2=(1, 8), conv3=(1, 16), conv4=(1, 16))
    cfg.model.img_extractor = FeatureExtractorConfig(
        conv1=(1, 8), conv2=(1, 8), conv3=(1, 16), conv4=(1, 16))
    cfg.model.correlation = CorrelationConfig(max_displacement=2, padding=2)
    cfg.model.tower_dtype = "float32"
    cfg.train.max_iterations = 10
    return cfg
