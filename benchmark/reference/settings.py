"""Render settings: per-render flags with nullable overrides beating scene
defaults.

Parity reference: ``Assets/Models/RenderSettings.cs:7-70`` (field set and
override semantics) and the default values wired by the reference UI
(``Assets/SceneBuilder.cs:334-343,400-401,435-445,481``): depth 2, AA 1,
intensity 1.0, all lighting toggles on, glossy roughness 0.05, shadow light
sizes {0,5,10,20}, blur shutter speeds {0,0.5,1,2}.

A frozen copy of the port's ``models/settings.py``, which the benchmark
does not import.
"""

from __future__ import annotations

from dataclasses import dataclass, asdict
from typing import Optional, Tuple


@dataclass(frozen=True)
class RenderSettings:
    """All knobs for one render. ``None`` means "use the scene file value".

    Fields that change compiled shapes / control flow (resolution, depth,
    AA, toggles) are treated as static by the renderer and trigger a re-jit
    when changed; float parameters (intensity, light size, ...) are traced
    and can change per call without recompilation.
    """

    # ----- output -----
    resolution_override: Optional[Tuple[int, int]] = None  # (width, height)
    background_color_override: Optional[Tuple[float, float, float]] = None
    light_intensity_scale: float = 1.0

    # ----- camera overrides -----
    camera_position_override: Optional[Tuple[float, float, float]] = None
    camera_rotation_override: Optional[Tuple[float, float, float]] = None  # Euler deg
    camera_fov_override: Optional[float] = None

    # ----- renderer -----
    max_depth: int = 2

    # ----- lighting component toggles -----
    enable_ambient: bool = True
    enable_diffuse: bool = True
    enable_specular: bool = True
    enable_refraction: bool = True

    # ----- projection -----
    is_orthographic: bool = False

    # ----- quality -----
    aa_samples: int = 1

    # ----- distributed-ray-tracing effects -----
    enable_soft_shadows: bool = False
    light_size: float = 0.0
    enable_glossy: bool = False
    surface_roughness: float = 0.0
    enable_motion_blur: bool = False
    shutter_speed: float = 0.0

    # ----- extensions beyond the reference -----
    # Analytic sphere/box intersection instead of tessellation (XLA
    # backend) — the live version of the reference's dead CPU oracle path
    # (HittableObjects.cs); exact silhouettes, no 768-triangle spheres.
    analytic_primitives: bool = False
    # 0 = faithful mode: only lights[0], light RGB ignored (white), exactly
    #     like the reference shader (RayTracer.cs:167-176, compute:383-418).
    # 1 = multi-light mode: all scene lights contribute with their RGB.
    multi_light: bool = False
    # Debug visualization (compute:484-508): 0=off 1=depth 2=normals 3=hit.
    debug_mode: int = 0

    def replace(self, **kw) -> "RenderSettings":
        import dataclasses

        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return asdict(self)
