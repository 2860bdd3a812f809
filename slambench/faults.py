"""Faults planted under the timed path, to show that `correct` comes out
false for each fault a cell can have: each wraps the program's
pipeline.step (install with `planted`). The cells have one chip, so the
exchange between chips is not among them. Used by the tests and by
readings.py's --fault."""

from __future__ import annotations

import contextlib


def unchanged(inner):
    """A step that returns its state unchanged."""
    from octree_slam_tpu_torch import convert

    def step(state, frame, cfg, render="splat", **kw):
        _, out = inner(convert.clone_state(state), frame, cfg, render=render,
                       **kw)
        return state, out
    return step


def half_frame(inner):
    """Half of the frame's rows left out of the step."""
    def step(state, frame, cfg, render="splat", **kw):
        depth = frame.depth.clone()
        depth[depth.shape[0] // 2:] = 0
        return inner(state, frame._replace(depth=depth), cfg, render=render,
                     **kw)
    return step


def moved_pose(inner):
    """The answer altered where it is produced: the pose off by 1 mm."""
    def step(state, frame, cfg, render="splat", **kw):
        state, out = inner(state, frame, cfg, render=render, **kw)
        pose = out.pose.clone()
        pose[0, 3] += 1e-3
        return state._replace(pose=pose), out._replace(pose=pose)
    return step


def inverted_view(inner):
    """The answer altered where it is produced: the view's colours
    inverted."""
    def step(state, frame, cfg, render="splat", **kw):
        state, out = inner(state, frame, cfg, render=render, **kw)
        fb = out.framebuffer.clone()
        fb[..., :3] = 1.0 - fb[..., :3]
        return state, out._replace(framebuffer=fb)
    return step


FAULTS = {f.__name__: f for f in (unchanged, half_frame, moved_pose,
                                  inverted_view)}


@contextlib.contextmanager
def planted(name: str):
    """pipeline.step replaced by FAULTS[name] of it, for the block."""
    from octree_slam_tpu_torch import pipeline
    inner = pipeline.step
    pipeline.step = FAULTS[name](inner)
    try:
        yield
    finally:
        pipeline.step = inner
