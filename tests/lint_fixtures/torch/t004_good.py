"""GOOD: true division through device.div; literal-only quotients are
constants folded on the host."""
from repro_torch.device import div


def rates(x, y, rate_h):
    per_s = div(rate_h, 3600.0)
    inv = 1.0 / x
    third = 1.0 / 3.0
    day = 1.0 / (24 * 3600.0)
    ratio = x / y
    steps = x // 2
    half = x * 0.5
    return per_s, inv, third, day, ratio, steps, half
