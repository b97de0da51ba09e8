"""Valid shading rows an image's first budget rung dropped and the
budget ladder rendered again (render_image's `sr_overflow`), the mean
over the window's images."""


def read(ctx):
    rows = ctx["ladder_rows"]
    if ctx["kind"] != "render" or not rows:
        return None
    return sum(rows) / len(rows)
