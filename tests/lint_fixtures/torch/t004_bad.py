"""BAD (when linted on a bitwise path): division by a numeric literal,
which CUDA turns into a multiply by the reciprocal."""


def rates(x, rate_h):
    per_s = rate_h / 3600.0                     # T004
    half = x / 2                                # T004
    neg = x / -1.0                              # T004
    day = x / (24 * 3600.0)                     # T004
    x /= 4.0                                    # T004
    return per_s, half, neg, day, x
