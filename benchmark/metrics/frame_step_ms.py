"""frame_step_ms: device milliseconds a frame-step on the pool's stream:
CUDA events around each of the window's calls to the tick clone's
``_replay_frames`` (the backbone-step and frame-sampling graphs of n
frame-steps), summed, over the frame-steps they ran."""


def read(run, name):
    s = run.frame_step_s
    return None if s is None else 1e3 * s
