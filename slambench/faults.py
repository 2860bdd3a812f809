"""Faults planted under the timed path, to show that `correct` comes out
false for each fault a cell can have: each wraps a function of the
program, pipeline.step or, for `moved_recovery`, relocalize.relocalize
(install with `planted`). The cells have one chip, so the exchange
between chips is not among them. Used by the tests and by readings.py's
--fault."""

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


def moved_recovery(inner):
    """The answer altered where it is produced: a relocalized pose off by
    1 mm (a run with no tracking loss never calls it)."""
    def relocalize(state, cfg, keyposes):
        pose, ok, diag = inner(state, cfg, keyposes)
        if ok:
            pose = pose.copy()
            pose[0, 3] += 1e-3
        return pose, ok, diag
    return relocalize


# the faults of pipeline.step, which every run calls
STEP_FAULTS = {f.__name__: f for f in (unchanged, half_frame, moved_pose,
                                       inverted_view)}
FAULTS = dict(STEP_FAULTS, moved_recovery=moved_recovery)
# the program's module and function each fault wraps
TARGETS = dict({name: ("pipeline", "step") for name in STEP_FAULTS},
               moved_recovery=("relocalize", "relocalize"))


@contextlib.contextmanager
def planted(name: str):
    """The program's function that FAULTS[name] wraps replaced by the
    fault of it, for the block."""
    import importlib
    module, attr = TARGETS[name]
    mod = importlib.import_module(f"octree_slam_tpu_torch.{module}")
    inner = getattr(mod, attr)
    setattr(mod, attr, FAULTS[name](inner))
    try:
        yield
    finally:
        setattr(mod, attr, inner)
