"""Prompt and output tokens of the invokes completed in the window over the
window's seconds (a closed loop's window ends when its last invoke returns)."""


def read(run):
    t = run.cell.traffic
    done = sum(1 for s in run.served if s.tokens is not None)
    return done * t["batch"] * (t["prompt_len"] + t["output_tokens"]) / run.window_s
