"""Per-scene Tanks & Temples eval overrides.

Resolution caps and 3-stage confidence thresholds per scene, matching
the tuned values shipped with the reference (filter/tank_test_config.py:
intermediate scenes individually tuned, advanced scenes loose photo
thresholds) — as plain dataclass records instead of a yacs CfgNode.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SceneConfig:
    max_h: int
    max_w: int
    conf: tuple[float, float, float]


_HD = dict(max_h=1080, max_w=2048)

TANK_SCENE_CONFIG: dict[str, SceneConfig] = {
    # intermediate
    "Family": SceneConfig(**_HD, conf=(0.6, 0.7, 0.95)),
    "Francis": SceneConfig(**_HD, conf=(0.6, 0.7, 0.95)),
    "Horse": SceneConfig(**_HD, conf=(0.15, 0.4, 0.8)),
    "Lighthouse": SceneConfig(**_HD, conf=(0.6, 0.7, 0.95)),
    "M60": SceneConfig(**_HD, conf=(0.35, 0.65, 0.85)),
    "Panther": SceneConfig(max_h=896, max_w=1216, conf=(0.1, 0.15, 0.9)),
    "Playground": SceneConfig(**_HD, conf=(0.6, 0.75, 0.95)),
    "Train": SceneConfig(**_HD, conf=(0.3, 0.6, 0.95)),
    # advanced
    "Auditorium": SceneConfig(**_HD, conf=(0.0, 0.0, 0.4)),
    "Ballroom": SceneConfig(**_HD, conf=(0.0, 0.0, 0.5)),
    "Courtroom": SceneConfig(**_HD, conf=(0.0, 0.0, 0.4)),
    "Museum": SceneConfig(**_HD, conf=(0.0, 0.0, 0.7)),
    "Palace": SceneConfig(**_HD, conf=(0.0, 0.0, 0.7)),
    "Temple": SceneConfig(**_HD, conf=(0.0, 0.0, 0.4)),
}
