"""Configuration tiers: constants, the static ``RenderConfig`` and the dynamic
per-frame ``Settings`` (counterpart of ``nrdsample_tpu/config.py``).

``Settings`` holds 0-d tensors so a frame can read them on the device without
a host round trip; ``RenderConfig`` is a frozen dataclass of Python values.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

import torch

from nrdsample_tpu_torch.device import resolve


class NrdMode(enum.IntEnum):
    NORMAL = 0
    SH = 1
    OCCLUSION = 2
    DIRECTIONAL_OCCLUSION = 3


class Denoiser(enum.IntEnum):
    REBLUR = 0
    RELAX = 1
    REFERENCE = 2
    NEURAL = 3


class TracingMode(enum.IntEnum):
    FULL = 0
    FULL_PROBABILISTIC = 1
    HALF = 2


class OnScreen(enum.IntEnum):
    FINAL = 0
    DENOISED_DIFFUSE = 1
    DENOISED_SPECULAR = 2
    AMBIENT_OCCLUSION = 3
    SPECULAR_OCCLUSION = 4
    SHADOW = 5
    BASE_COLOR = 6
    NORMAL = 7
    ROUGHNESS = 8
    METALNESS = 9
    MATERIAL_ID = 10
    PSR_THROUGHPUT = 11
    WORLD_UNITS = 12
    INSTANCE_INDEX = 13
    UV = 14
    CURVATURE = 15
    MIP_PRIMARY = 16
    MIP_SPECULAR = 17
    SHARC_CACHE = 18
    SHARC_GRID = 19
    TAA_WEIGHT = 20


class ForcedMaterial(enum.IntEnum):
    NONE = 0
    GYPSUM = 1
    COBALT = 2


MATERIAL_ID_DEFAULT = 0.0
MATERIAL_ID_METAL = 1.0
MATERIAL_ID_HAIR = 2.0
MATERIAL_ID_SELF_REFLECTION = 3.0

PT_THROUGHPUT_THRESHOLD = 0.001
PT_IMPORTANCE_SAMPLES_NUM = 16
PT_SPEC_LOBE_ENERGY = 0.95
PT_SHADOW_RAY_OFFSET = 0.25  # pixels
PT_BOUNCE_RAY_OFFSET = 0.25  # pixels
PT_GLASS_RAY_OFFSET = 0.05  # pixels
PT_EVIL_TWIN_LOBE_TOLERANCE = 0.005
PT_DELTA_BOUNCES_NUM = 16
PT_PSR_BOUNCES_NUM = 2
SHARC_GRADIENT_HITDIST_SCALE = 3.0
PT_SHADOW_GLASS_LAYERS = 4

SHARC_CAPACITY = 1 << 22
SHARC_SCENE_SCALE = 45.0
SHARC_DOWNSCALE = 5
SHARC_RESPONSIVE_FRAME_NUM = 32
SHARC_STALE_FRAME_NUM_MIN = 8
SHARC_RADIANCE_SCALE = 100.0
SHARC_RESAMPLING_DEPTH_MIN = 1
SHARC_PROPAGATION_DEPTH = 4

INF = 1e5
MAX_MIP_LEVEL = 11.0
LEAF_TRANSLUCENCY = 0.25
LEAF_THICKNESS = 0.001
TAA_HISTORY_SHARPNESS = 0.66
TAA_SIGMA_SCALE = 2.0

SKY_INTENSITY = 1.0
SUN_INTENSITY = 10.0

FLAG_NON_TRANSPARENT = 0x01
FLAG_TRANSPARENT = 0x02
FLAG_FORCED_EMISSION = 0x04
FLAG_STATIC = 0x08
FLAG_HAIR = 0x10
FLAG_LEAF = 0x20
FLAG_SKIN = 0x40
FLAG_MORPH = 0x80
FLAG_ALPHA_TEST = 0x100
GEOMETRY_ALL = FLAG_NON_TRANSPARENT | FLAG_TRANSPARENT


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration (same fields and defaults as the JAX
    package's)."""

    width: int = 256
    height: int = 256
    rpp: int = 1
    bounce_num: int = 1
    delta_bounce_num: int = 4
    psr_bounce_num: int = 0
    nrd_mode: NrdMode = NrdMode.NORMAL
    tracing_mode: TracingMode = TracingMode.FULL_PROBABILISTIC
    on_screen: OnScreen = OnScreen.FINAL
    use_importance_sampling: bool = True
    use_blue_noise: bool = True
    importance_samples: int = PT_IMPORTANCE_SAMPLES_NUM
    use_sharc: bool = False
    sharc_capacity: int = SHARC_CAPACITY
    sharc_downscale: int = SHARC_DOWNSCALE
    sharc_full_mode: bool = True
    use_l1_cache: bool = False
    use_confidence: bool = False
    use_white_furnace: bool = False
    use_hair_sss: bool = False
    use_translucency: bool = True
    denoiser: Denoiser = Denoiser.REFERENCE
    use_taa: bool = False
    output_width: int = 0
    output_height: int = 0
    use_nis: bool = False
    use_neural_sr: bool = False
    enable_post: bool = False
    dtype: Any = torch.float32
    use_validation_overlay: bool = False
    use_moving_emission_fix: bool = True
    use_inf_stress_test: bool = False
    use_drs_stress_test: bool = False
    use_firefly_test: bool = False
    use_material_id_test: bool = False
    use_sanitization: bool = False

    @property
    def n_pixels(self) -> int:
        return self.width * self.height


def _f32(v):
    return dataclasses.field(default_factory=lambda: torch.tensor(v, dtype=torch.float32))


def _i32(v):
    return dataclasses.field(default_factory=lambda: torch.tensor(v, dtype=torch.int32))


@dataclasses.dataclass
class Settings:
    """Dynamic per-frame settings: every field is a 0-d tensor (float32 or
    int32, as in the JAX package)."""

    sun_azimuth: torch.Tensor = _f32(-147.0)
    sun_elevation: torch.Tensor = _f32(45.0)
    sun_angular_diameter: torch.Tensor = _f32(0.533)
    exposure: torch.Tensor = _f32(80.0)
    roughness_override: torch.Tensor = _f32(0.0)
    metalness_override: torch.Tensor = _f32(0.0)
    forced_material: torch.Tensor = _i32(0)
    emission_intensity: torch.Tensor = _f32(1.0)
    emission_intensity_cubes: torch.Tensor = _f32(1.0)
    use_normal_map: torch.Tensor = _i32(1)
    indirect_diffuse: torch.Tensor = _i32(1)
    indirect_specular: torch.Tensor = _i32(1)
    cam_fov: torch.Tensor = _f32(0.0)
    blink: torch.Tensor = _i32(0)
    mv_type: torch.Tensor = _i32(0)
    debug: torch.Tensor = _f32(0.0)
    separator: torch.Tensor = _f32(0.0)
    max_accumulated_frame_num: torch.Tensor = _i32(31)
    min_probability: torch.Tensor = _f32(0.0)
    disable_shadows: torch.Tensor = _i32(0)
    prev_frame_confidence: torch.Tensor = _f32(1.0)
    sharpness: torch.Tensor = _f32(0.15)
    resolution_scale: torch.Tensor = _f32(1.0)

    def to_flat(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def to(self, device) -> "Settings":
        return Settings(**{k: v.to(device) for k, v in self.to_flat().items()})


def make_settings(device=None, **values) -> Settings:
    """Settings with the given fields overridden from Python numbers, each
    cast to its field's dtype, on ``device`` (the CUDA card when None)."""
    s = Settings()
    kw = {k: torch.tensor(v, dtype=getattr(s, k).dtype) for k, v in values.items()}
    return dataclasses.replace(s, **kw).to(resolve(device))


def sun_direction(settings: Settings) -> torch.Tensor:
    """World-space unit sun direction (3,) from azimuth/elevation degrees."""
    az = torch.deg2rad(settings.sun_azimuth)
    el = torch.deg2rad(settings.sun_elevation)
    cos_el = torch.cos(el)
    return torch.stack([cos_el * torch.cos(az), cos_el * torch.sin(az), torch.sin(el)])
