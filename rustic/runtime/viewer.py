"""Interactive progressive viewer — the reference app-layer analog.

The reference wraps the tracer in a winit/egui GUI with a fly camera,
live settings, and progressive display (reference: src/app.rs). This
framework is headless-first, but this module provides the same
interactive loop on top of matplotlib when a display is available:

- progressive accumulation republished every sync_rate samples,
- WASD + QE fly camera (shift = 10x, ctrl = 0.1x speed), arrow-key look
  AND mouse-drag look (reference: src/app.rs:439-492 — the right-click
  -drag camera),
- sun controls j/l (azimuth), i/k (elevation), =/- (intensity) — the
  reference's environment GUI (src/app.rs:365-437),
- keys for NEE mode (n), tonemap cycling (t), denoise (x), save (p),
- runtime scene/skybox switching: drag-drop onto the window when the
  backend supports it (TkAgg + tkinterdnd2), plus 'o' (open scene) and
  'u' (load skybox) terminal prompts — the reference's drag-drop loader
  + file pickers (src/app.rs:617-624, image detection :44-52),
- 'c' toggles CPU<->GPU compute with the accumulated film preserved
  (the reference's "Use CPU" switch + continue_previous restore,
  src/app.rs:324-346, src/trace.rs:162-164),
- camera moves mark the state dirty and restart accumulation, exactly
  like the reference's interacting/dirty flags (src/trace.rs:216-222).

Run: python -m rustic.cli render <scene.glb> --interactive
"""

from __future__ import annotations

import math
import os
import time
from typing import Optional

import numpy as np

from rustic.config import (
    NextEventEstimation,
    RenderSettings,
    Tonemapping,
    TracingConfig,
)
from rustic.ops.tonemap import apply_tonemap
from rustic.runtime.state import TracingState

_MOVE_SPEED = 0.3  # reference: src/app.rs speed with shift/ctrl modifiers
_TURN_SPEED = 0.05
_MOUSE_SENS = 0.005  # radians per pixel of drag

# the reference detects dropped images by extension (src/app.rs:44-52)
_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".hdr", ".exr", ".tga", ".bmp")


class Viewer:
    def __init__(
        self,
        scene,
        config: TracingConfig,
        settings: Optional[RenderSettings] = None,
        world=None,
        skybox: Optional[np.ndarray] = None,
    ):
        self.scene = scene
        self.world = world  # host-side World, kept for runtime switching
        self.skybox = skybox  # loaded skybox image (np array) or None
        self.settings = settings or RenderSettings(sync_rate=4)
        self.state = TracingState(
            config.width, config.height, config, self.settings
        )
        self.tonemap = self.settings.tonemap
        self._running = True
        self._drag = None  # (x, y) of the last mouse-drag position
        self._scene_cpu = None  # CPU-resident scene cache for 'c' toggle

    # -- camera (reference: src/app.rs:439-492) -----------------------------

    def _move(self, forward=0.0, right=0.0, up=0.0, speed_scale=1.0):
        cfg = self.state.config
        pitch, yaw = cfg.cam_rotation
        # camera looks along Ry(yaw)Rx(pitch) @ +z
        fwd = (
            math.sin(yaw) * math.cos(pitch),
            -math.sin(pitch),
            math.cos(yaw) * math.cos(pitch),
        )
        rgt = (math.cos(yaw), 0.0, -math.sin(yaw))
        step = _MOVE_SPEED * speed_scale
        pos = tuple(
            p + step * (forward * f + right * r)
            for p, f, r in zip(cfg.cam_position, fwd, rgt)
        )
        pos = (pos[0], pos[1] + step * up, pos[2])
        self.state.set_config(cam_position=pos)

    def _orbit_sun(self, dazimuth=0.0, delevation=0.0, dintensity=0.0):
        """Sun controls (reference: src/app.rs:365-437 — the environment
        GUI's intensity slider + draggable sun-position disc)."""
        x, y, z, intensity = self.state.config.sun_direction
        r = max(math.sqrt(x * x + y * y + z * z), 1e-6)
        azimuth = math.atan2(z, x) + dazimuth
        elevation = math.asin(max(-1.0, min(1.0, y / r))) + delevation
        elevation = max(-1.55, min(1.55, elevation))
        intensity = max(0.0, intensity * (1.0 + dintensity))
        self.state.set_config(
            sun_direction=(
                math.cos(elevation) * math.cos(azimuth),
                math.sin(elevation),
                math.cos(elevation) * math.sin(azimuth),
                intensity,
            )
        )

    def _turn(self, dpitch=0.0, dyaw=0.0):
        cfg = self.state.config
        self.state.set_config(
            cam_rotation=(
                cfg.cam_rotation[0] + dpitch * _TURN_SPEED,
                cfg.cam_rotation[1] + dyaw * _TURN_SPEED,
            )
        )

    def handle_key(self, key: str) -> bool:
        """Apply one key action; returns False when the viewer should quit.

        shift+<move> = 10x speed, ctrl+<move> = 0.1x (reference:
        src/app.rs:439-492's shift/ctrl fly-camera modifiers)."""
        speed = 1.0
        while "+" in key and key.split("+", 1)[0] in ("shift", "ctrl"):
            mod, key = key.split("+", 1)
            speed *= 10.0 if mod == "shift" else 0.1
        if len(key) == 1 and key.isalpha() and key.isupper():
            # matplotlib delivers shift+letter as the bare uppercase
            # letter, not "shift+x"
            speed *= 10.0
            key = key.lower()
        actions = {
            "w": lambda: self._move(forward=1, speed_scale=speed),
            "s": lambda: self._move(forward=-1, speed_scale=speed),
            "a": lambda: self._move(right=-1, speed_scale=speed),
            "d": lambda: self._move(right=1, speed_scale=speed),
            "q": lambda: self._move(up=-1, speed_scale=speed),
            "e": lambda: self._move(up=1, speed_scale=speed),
            "up": lambda: self._turn(dpitch=-1),
            "down": lambda: self._turn(dpitch=1),
            "left": lambda: self._turn(dyaw=-1),
            "right": lambda: self._turn(dyaw=1),
            "j": lambda: self._orbit_sun(dazimuth=-0.1),
            "l": lambda: self._orbit_sun(dazimuth=0.1),
            "i": lambda: self._orbit_sun(delevation=0.1),
            "k": lambda: self._orbit_sun(delevation=-0.1),
            "=": lambda: self._orbit_sun(dintensity=0.25),
            "-": lambda: self._orbit_sun(dintensity=-0.2),
        }
        if key in actions:
            actions[key]()
            return True
        if key == "o":  # open scene (reference's scene picker/drag-drop)
            self._prompt_load("scene path (.glb/.gltf/.obj/.fbx/.stl/.ply): ")
        elif key == "u":  # load skybox image
            self._prompt_load("skybox image path (.hdr/.png/...): ")
        elif key == "c":  # CPU<->GPU switch, film preserved
            self.toggle_backend()
        elif key == "n":  # cycle NEE mode
            cfg = self.state.config
            self.state.set_config(
                nee=NextEventEstimation((int(cfg.nee) + 1) % 3)
            )
        elif key == "t":  # cycle tonemap operator
            self.tonemap = Tonemapping(
                (int(self.tonemap) + 1) % len(Tonemapping)
            )
        elif key == "x":  # toggle denoise
            self.settings.denoise = not self.settings.denoise
        elif key == "p":  # save PNG
            from rustic.utils.image_io import save_png

            save_png("viewer_capture.png", self.state.framebuffer, self.tonemap)
        elif key == "escape":
            self._running = False
            return False
        return True

    # -- runtime scene/skybox switching (reference: src/app.rs:617-624) ------

    def _prompt_load(self, prompt: str):
        """Terminal-prompt analog of the reference's file pickers; empty
        input cancels."""
        try:
            path = input(prompt).strip().strip("'\"")
        except (EOFError, OSError):
            return
        if path:
            self.load_path(path)

    def load_path(self, path: str) -> bool:
        """Load a dropped/picked file: images become the skybox, any
        mesh format becomes the new scene (reference drag-drop handler,
        src/app.rs:617-624; image detection src/app.rs:44-52).
        Accumulation restarts, camera/settings persist."""
        path = path.strip().strip("'\"")
        if not os.path.exists(path):
            print(f"[viewer] no such file: {path}")
            return False
        try:
            if path.lower().endswith(_IMAGE_EXTS) or path.lower().endswith(
                ".npy"
            ):
                from rustic.scene.world import load_skybox_image

                self.skybox = (
                    np.load(path)
                    if path.lower().endswith(".npy")
                    else load_skybox_image(path)
                )
                if self.world is not None:
                    self.scene = self.world.to_device(self.skybox)
                self.state.set_config(has_skybox=True)
            else:
                from rustic.scene.world import World

                self.world = World.from_path(path)
                self.scene = self.world.to_device(self.skybox)
                self.state.mark_dirty()
        except Exception as e:  # keep the viewer alive on bad drops
            print(f"[viewer] load failed: {e}")
            return False
        self._scene_cpu = None  # invalidate the CPU copy
        if self.settings.backend == "cpu":
            self._ensure_cpu_scene()
        return True

    # -- CPU<->GPU switch (reference: src/app.rs:324-346) --------------------

    def _ensure_cpu_scene(self):
        import jax

        if self._scene_cpu is None:
            self._scene_cpu = jax.device_put(
                self.scene, jax.devices("cpu")[0]
            )

    def active_scene(self):
        return (
            self._scene_cpu if self.settings.backend == "cpu" else self.scene
        )

    def toggle_backend(self):
        """Flip compute between the default backend and the CPU twin;
        the accumulated film and sample count carry over (the
        reference's continue_previous restore, src/trace.rs:162-164)."""
        if self.settings.backend == "cpu":
            self.settings.backend = "auto"
        else:
            self.settings.backend = "cpu"
            self._ensure_cpu_scene()
        # restore (not reset): sum = mean * samples survives the switch
        self.state.restore(self.state.framebuffer, self.state.samples)

    # -- mouse-drag look (reference: src/app.rs:439-492) ---------------------

    def on_mouse_press(self, x: float, y: float):
        self._drag = (x, y)
        self.state.interacting = True

    def on_mouse_move(self, x: float, y: float):
        if self._drag is None:
            return
        dx, dy = x - self._drag[0], y - self._drag[1]
        self._drag = (x, y)
        cfg = self.state.config
        # matplotlib y grows upward in figure coords; dragging right
        # turns right, dragging up looks up (reference sign convention)
        self.state.set_config(
            cam_rotation=(
                cfg.cam_rotation[0] + dy * _MOUSE_SENS,
                cfg.cam_rotation[1] + dx * _MOUSE_SENS,
            )
        )

    def on_mouse_release(self):
        self._drag = None
        self.state.interacting = False

    def display_frame(self) -> np.ndarray:
        import jax.numpy as jnp

        return np.asarray(
            apply_tonemap(jnp.asarray(self.state.framebuffer), self.tonemap)
        )

    def step(self) -> np.ndarray:
        self.state.step(self.active_scene())
        return self.display_frame()

    def _try_enable_dnd(self, fig):
        """Native drag-drop when available (TkAgg + the tkdnd extension);
        the 'o'/'u' prompts remain the portable path."""
        try:
            widget = fig.canvas.get_tk_widget()
            from tkinterdnd2 import DND_FILES  # optional dependency

            widget.drop_target_register(DND_FILES)
            widget.dnd_bind(
                "<<Drop>>", lambda e: self.load_path(e.data.strip("{}"))
            )
        except Exception:
            pass  # backend without DnD: keyboard prompts cover it

    # -- matplotlib event loop ----------------------------------------------

    def run(self):
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(10, 6))
        fig.canvas.manager.set_window_title("rustic")
        im = ax.imshow(self.display_frame())
        ax.axis("off")
        status = ax.set_title("starting…")

        def on_key(event):
            if not self.handle_key(event.key or ""):
                plt.close(fig)

        fig.canvas.mpl_connect("key_press_event", on_key)
        fig.canvas.mpl_connect(
            "button_press_event",
            lambda e: self.on_mouse_press(e.x, e.y),
        )
        fig.canvas.mpl_connect(
            "motion_notify_event",
            lambda e: self.on_mouse_move(e.x, e.y),
        )
        fig.canvas.mpl_connect(
            "button_release_event", lambda e: self.on_mouse_release()
        )
        self._try_enable_dnd(fig)
        plt.ion()
        plt.show()
        t0 = time.time()
        while self._running and plt.fignum_exists(fig.number):
            frame = self.step()
            im.set_data(frame)
            status.set_text(
                f"{self.state.samples} spp | "
                f"{self.state.samples / max(time.time() - t0, 1e-9):.1f} spp/s | "
                f"nee={self.state.config.nee.name} "
                f"tonemap={Tonemapping(self.tonemap).name}"
            )
            fig.canvas.draw_idle()
            fig.canvas.flush_events()
        plt.ioff()
