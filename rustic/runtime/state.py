"""Progressive tracing state — the interactive driver.

The analog of the reference's TracingState + trace loop
(reference: src/trace.rs:40-92, 136-224): a mean framebuffer published
after every sync_rate samples, dirty/interacting flags that reset the
accumulator, config edits that take effect at the next flush, and
accumulation that survives engine switches (continue_previous semantics,
src/trace.rs:162-164 restores sum = mean * samples).

Thread-free by design: JAX dispatch is async already, so `step()` is the
dispatch boundary and callers (CLI, notebooks, a viewer) drive the loop.
A convenience `run()` loops until a sample target or `stop()`.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional

import numpy as np

import jax.numpy as jnp

from rustic.config import RenderSettings, TracingConfig
from rustic.runtime.render import pixel_offsets, render_pixels


class TracingState:
    def __init__(
        self,
        width: int,
        height: int,
        config: Optional[TracingConfig] = None,
        settings: Optional[RenderSettings] = None,
    ):
        self.config = (config or TracingConfig()).replace(width=width, height=height)
        self.settings = settings or RenderSettings()
        self.samples = 0
        self.running = False
        self.interacting = False
        self._dirty = False
        self._lock = threading.Lock()
        w, h = width, height
        self._px = np.mgrid[0:h, 0:w][1].reshape(-1).astype(np.int32)
        self._py = np.mgrid[0:h, 0:w][0].reshape(-1).astype(np.int32)
        self._offsets = pixel_offsets(w, h, self.settings.use_blue_noise)
        self._film_sum = jnp.zeros((w * h, 3), jnp.float32)
        self.framebuffer = np.zeros((h, w, 3), np.float32)  # published mean

    # -- control ------------------------------------------------------------

    def mark_dirty(self):
        """Config changed: reset accumulation at the next step boundary
        (reference: the `dirty` atomic, src/trace.rs:216-222)."""
        self._dirty = True

    def set_config(self, **updates):
        with self._lock:
            self.config = self.config.replace(**updates)
        self.mark_dirty()

    def restore(self, framebuffer: np.ndarray, samples: int):
        """Continue a previous accumulation (engine switch / resume):
        sum = mean * samples (reference: src/trace.rs:162-164)."""
        mean = framebuffer.reshape(-1, 3).astype(np.float32)
        self._film_sum = jnp.asarray(mean * float(samples))
        self.samples = samples
        self.framebuffer = framebuffer.copy()

    def stop(self):
        self.running = False

    def reset(self):
        self.samples = 0
        w, h = self.config.width, self.config.height
        if w * h != len(self._px):
            # resolution changed via set_config: rebuild the pixel set
            self._px = np.mgrid[0:h, 0:w][1].reshape(-1).astype(np.int32)
            self._py = np.mgrid[0:h, 0:w][0].reshape(-1).astype(np.int32)
            self._film_sum = jnp.zeros((w * h, 3), jnp.float32)
            self.framebuffer = np.zeros((h, w, 3), np.float32)
        else:
            self._film_sum = jnp.zeros_like(self._film_sum)
        self._offsets = pixel_offsets(w, h, self.settings.use_blue_noise)
        self._dirty = False

    # -- stepping -----------------------------------------------------------

    def step(self, scene, n_samples: Optional[int] = None) -> np.ndarray:
        """Fold n_samples (default sync_rate) into the accumulator and
        publish the mean framebuffer. Returns the published frame."""
        if self._dirty or self.interacting:
            self.reset()
        n = n_samples if n_samples is not None else self.settings.sync_rate
        with self._lock:
            config = self.config
        self._film_sum = render_pixels(
            scene,
            config,
            self._px,
            self._py,
            n,
            offsets=self._offsets,
            sample_start=self.samples,
            engine=self.settings.engine,
            film_in=self._film_sum,
            backend=self.settings.backend,
        )
        self.samples += n
        mean = np.asarray(self._film_sum) / max(self.samples, 1)
        frame = mean.reshape(config.height, config.width, 3)
        if self.settings.denoise:
            from rustic.runtime.denoise import denoise

            frame = denoise(frame)
        self.framebuffer = frame
        return frame

    def run(
        self,
        scene,
        target_samples: Optional[int] = None,
        on_frame: Optional[Callable[[np.ndarray, int], None]] = None,
    ) -> np.ndarray:
        """Loop step() until target_samples (or stop()). The synchronous
        test-harness analog of the reference's setup_trace watcher
        (src/trace.rs:331-344)."""
        self.running = True
        while self.running:
            if target_samples is not None:
                remaining = target_samples - self.samples
                if remaining <= 0:
                    break
                n = min(self.settings.sync_rate, remaining)
            else:
                n = self.settings.sync_rate
            frame = self.step(scene, n)
            if on_frame is not None:
                on_frame(frame, self.samples)
        self.running = False
        return self.framebuffer


@dataclasses.dataclass
class Checkpoint:
    """On-disk render checkpoint: film sum + sample count + config."""

    film_sum: np.ndarray
    samples: int
    config: TracingConfig

    def save(self, path: str):
        # write through a file object: np.savez appends '.npz' to bare
        # string paths, which would break the resume-path existence check
        with open(path, "wb") as f:
            self._savez(f)

    def _savez(self, f):
        np.savez_compressed(
            f,
            film_sum=self.film_sum,
            samples=self.samples,
            config=np.asarray(
                [
                    self.config.width,
                    self.config.height,
                    self.config.min_bounces,
                    self.config.max_bounces,
                    int(self.config.nee),
                    int(self.config.has_skybox),
                    *self.config.cam_position,
                    *self.config.cam_rotation,
                    *self.config.sun_direction,
                    *self.config.specular_weight_clamp,
                ],
                np.float64,
            ),
        )

    @classmethod
    def load(cls, path: str) -> "Checkpoint":
        data = np.load(path)
        c = data["config"]
        config = TracingConfig(
            width=int(c[0]),
            height=int(c[1]),
            min_bounces=int(c[2]),
            max_bounces=int(c[3]),
            nee=int(c[4]),
            has_skybox=bool(c[5]),
            cam_position=tuple(c[6:9]),
            cam_rotation=tuple(c[9:11]),
            sun_direction=tuple(c[11:15]),
            specular_weight_clamp=tuple(c[15:17]),
        )
        return cls(
            film_sum=data["film_sum"], samples=int(data["samples"]), config=config
        )

    @classmethod
    def from_state(cls, state: TracingState) -> "Checkpoint":
        return cls(
            film_sum=np.asarray(state._film_sum),
            samples=state.samples,
            config=state.config,
        )

    def into_state(self, settings: Optional[RenderSettings] = None) -> TracingState:
        state = TracingState(
            self.config.width, self.config.height, self.config, settings
        )
        # assign the stored sum directly — a mean round-trip through
        # restore() would add avoidable float32 error to the accumulator
        state._film_sum = jnp.asarray(
            np.asarray(self.film_sum, np.float32).reshape(-1, 3)
        )
        state.samples = int(self.samples)
        state.framebuffer = (
            np.asarray(self.film_sum, np.float32) / max(int(self.samples), 1)
        ).reshape(self.config.height, self.config.width, 3)
        return state
