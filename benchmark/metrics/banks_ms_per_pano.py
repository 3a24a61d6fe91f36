"""Device time of the kernels launched while a floor's banks are built
(`build_banks`: identity and extended renders of both surfaces), over the
panos banked, in ms (device trace)."""


def read(ctx):
    t = ctx.get("trace")
    panos = sum(r["panos"] for r in ctx.get("launches", {}).get("build_banks", []))
    if t is None or panos <= 0:
        return None
    kernels = t.kernels_in("build_banks")
    if not kernels:
        return None
    return 1e3 * sum(k.dur for k in kernels) / panos
