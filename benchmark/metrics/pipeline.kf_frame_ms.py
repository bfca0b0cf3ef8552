"""Mean host-clock ms of ``process`` on keyframe frames, the wait on the
mapper's bounded keyframe queue included; frames of the profiled slice are
left out.  Serves ``pipeline.kf_frame_ms.offline`` and ``.live``."""


def read(ctx):
    rec = ctx["frames"]
    a, b = ctx["slice"]
    ms = [1e3 * (r - c) for i, (c, r, kf) in enumerate(zip(rec["t_call"], rec["t_ret"],
                                                          rec["is_kf"]))
          if kf and not a <= i < b]
    return sum(ms) / len(ms) if ms else None
