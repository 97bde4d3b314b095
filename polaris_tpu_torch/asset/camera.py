"""Scene camera: pitch/yaw orbit + frustum-corner ray basis.

Counterpart of the reference's ``asset/scene/camera.go``: the camera's key
output is the 4 frustum-corner ray vectors (invViewProj x clip corners, with
perspective divide, minus the eye position — camera.go:114-141); the device
ray generator bilinearly interpolates these per pixel (camera.cl:46-53).

The reference's ``Perspective4`` treats the FOV-in-degrees value as radians
(the conversion at types/matrix.go:157 is commented out); we use the correct
degree FOV (see docs/parity.md).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import types as T


@dataclass
class Camera:
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    look_at: np.ndarray = field(
        default_factory=lambda: np.array([0, 0, -1], np.float32)
    )
    up: np.ndarray = field(default_factory=lambda: np.array([0, 1, 0], np.float32))
    fov: float = 45.0
    pitch: float = 0.0
    yaw: float = 0.0
    invert_y: bool = False

    proj: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))
    view: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))
    frustum: np.ndarray = field(
        default_factory=lambda: np.zeros((4, 3), np.float32)
    )

    @classmethod
    def from_scene(cls, scene, width: int, height: int, invert_y: bool = False):
        cam = cls(
            position=np.asarray(scene.camera_eye, np.float32).copy(),
            look_at=np.asarray(scene.camera_look, np.float32).copy(),
            up=np.asarray(scene.camera_up, np.float32).copy(),
            fov=float(scene.camera_fov),
            invert_y=invert_y,
        )
        cam.setup_projection(width / height)
        return cam

    def clone(self) -> "Camera":
        """Deep-copy the array fields so edits to the clone can never alias
        the live camera's state (the progressive viewer clones before
        buffering a pending camera change)."""
        c = Camera(**{**self.__dict__})
        for f in ("position", "look_at", "up", "proj", "view", "frustum"):
            setattr(c, f, np.array(getattr(self, f), np.float32))
        return c

    def setup_projection(self, aspect: float) -> None:
        """(ref: camera.go:68-71)"""
        self.proj = T.perspective(self.fov, aspect, 1.0, 1000.0)
        self.update()

    def move(self, direction: str, offset: float) -> None:
        """WASD-style movement (ref: camera.go:74-95)."""
        fwd = T.normalize(self.look_at - self.position)
        delta = {
            "up": self.up * offset,
            "down": self.up * -offset,
            "left": -np.cross(fwd, self.up) * offset,
            "right": np.cross(fwd, self.up) * offset,
            "forward": fwd * offset,
            "backward": -fwd * offset,
        }[direction]
        self.position = (self.position + delta).astype(np.float32)
        self.look_at = (self.look_at + delta).astype(np.float32)
        self.update()

    def update(self) -> None:
        """Apply pitch/yaw orbit and refresh view + frustum (camera.go:98-112)."""
        d = T.normalize(self.look_at - self.position)
        pitch_axis = np.cross(d, self.up)
        pitch_q = T.quat_from_axis_angle(pitch_axis, self.pitch)
        yaw_q = T.quat_from_axis_angle(self.up, self.yaw)
        orient = T.quat_normalize(T.quat_mul(pitch_q, yaw_q))
        d = T.quat_rotate(orient, d)
        self.look_at = (self.position + d).astype(np.float32)
        self.view = T.look_at(self.position, self.look_at, self.up)
        self._update_frustum()

    def _update_frustum(self) -> None:
        """Corner rays = persp-divided invViewProj clip corners - eye
        (camera.go:121-141). Order: TL, TR, BL, BR."""
        inv = np.linalg.inv(self.proj @ self.view).astype(np.float32)
        y_up = -1.0 if self.invert_y else 1.0
        corners = [(-1, y_up), (1, y_up), (-1, -y_up), (1, -y_up)]
        fr = np.zeros((4, 3), np.float32)
        for i, (cx, cy) in enumerate(corners):
            v = inv @ np.array([cx, cy, -1.0, 1.0], np.float32)
            fr[i] = v[:3] / v[3] - self.position
        self.frustum = fr
