"""JSON scene presets — persisted app state, same schema as the reference.

Parity reference: ``Assets/Models/ScenePreset.cs:9-139`` (field names and
defaults are kept identical so preset files round-trip between the two
implementations) and the save/load flow in ``Assets/SceneBuilder.cs:1057-1252``.

Note the reference quirk preserved here: ``FromRenderSettings`` does *not*
populate AASamples/ShadowMode/EnableGlossy/BlurMode — the caller sets those
top-bar fields afterwards (``SceneBuilder.cs:1085-1088``).

The port's copy of :mod:`cosig_tpu.models.preset`: the same schema, so a
preset file moves between the two packages unchanged.
"""

from __future__ import annotations

import datetime
import json
from dataclasses import dataclass, field, asdict
from typing import List, Optional

from cosig_tpu_torch.models.settings import RenderSettings

# UI mode tables from the reference (SceneBuilder.cs:62,69):
SHADOW_SIZES = [0.0, 5.0, 10.0, 20.0]  # ShadowMode index -> light size
BLUR_SPEEDS = [0.0, 0.5, 1.0, 2.0]  # BlurMode index -> shutter speed
GLOSSY_ROUGHNESS = 0.05  # hardcoded by the reference UI (SceneBuilder.cs:481)


@dataclass
class ScenePreset:
    SceneFilePath: Optional[str] = None
    ReferenceImagePath: Optional[str] = None
    ResolutionX: int = 256
    ResolutionY: int = 256
    BackgroundColor: List[float] = field(default_factory=lambda: [0.2, 0.2, 0.2])
    LightIntensity: float = 1.0
    CameraPosition: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    CameraRotation: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    CameraFov: float = 50.0
    IsOrthographic: bool = False
    RecursionDepth: int = 2
    EnableAmbient: bool = True
    EnableDiffuse: bool = True
    EnableSpecular: bool = True
    EnableRefraction: bool = True
    AASamples: int = 1
    ShadowMode: int = 0
    EnableGlossy: bool = False
    BlurMode: int = 0
    PresetName: str = "Untitled"
    SavedAt: str = ""

    # ------------------------------------------------------------------
    @staticmethod
    def from_render_settings(
        settings: RenderSettings,
        scene_file_path: Optional[str] = None,
        ref_image_path: Optional[str] = None,
    ) -> "ScenePreset":
        preset = ScenePreset(
            SceneFilePath=scene_file_path,
            ReferenceImagePath=ref_image_path,
            SavedAt=datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
        )
        if settings.resolution_override is not None:
            preset.ResolutionX, preset.ResolutionY = settings.resolution_override
        if settings.background_color_override is not None:
            preset.BackgroundColor = list(settings.background_color_override)
        preset.LightIntensity = settings.light_intensity_scale
        if settings.camera_position_override is not None:
            preset.CameraPosition = list(settings.camera_position_override)
        if settings.camera_rotation_override is not None:
            preset.CameraRotation = list(settings.camera_rotation_override)
        if settings.camera_fov_override is not None:
            preset.CameraFov = settings.camera_fov_override
        preset.IsOrthographic = settings.is_orthographic
        preset.RecursionDepth = settings.max_depth
        preset.EnableAmbient = settings.enable_ambient
        preset.EnableDiffuse = settings.enable_diffuse
        preset.EnableSpecular = settings.enable_specular
        preset.EnableRefraction = settings.enable_refraction
        return preset

    def to_render_settings(self) -> RenderSettings:
        """Inverse mapping, mirroring ApplyPresetToUI (SceneBuilder.cs:1168-1252)."""
        shadow_size = SHADOW_SIZES[self.ShadowMode] if 0 <= self.ShadowMode < len(SHADOW_SIZES) else 0.0
        shutter = BLUR_SPEEDS[self.BlurMode] if 0 <= self.BlurMode < len(BLUR_SPEEDS) else 0.0
        return RenderSettings(
            resolution_override=(self.ResolutionX, self.ResolutionY),
            background_color_override=tuple(self.BackgroundColor),
            light_intensity_scale=self.LightIntensity,
            camera_position_override=tuple(self.CameraPosition),
            camera_rotation_override=tuple(self.CameraRotation),
            camera_fov_override=self.CameraFov,
            is_orthographic=self.IsOrthographic,
            max_depth=self.RecursionDepth,
            enable_ambient=self.EnableAmbient,
            enable_diffuse=self.EnableDiffuse,
            enable_specular=self.EnableSpecular,
            enable_refraction=self.EnableRefraction,
            aa_samples=self.AASamples,
            enable_soft_shadows=self.ShadowMode > 0,
            light_size=shadow_size,
            enable_glossy=self.EnableGlossy,
            surface_roughness=GLOSSY_ROUGHNESS if self.EnableGlossy else 0.0,
            enable_motion_blur=self.BlurMode > 0,
            shutter_speed=shutter,
        )

    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(asdict(self), f, indent=2)

    @staticmethod
    def load(path: str) -> "ScenePreset":
        with open(path) as f:
            data = json.load(f)
        preset = ScenePreset()
        for k, v in data.items():
            if hasattr(preset, k):
                setattr(preset, k, v)
        return preset
