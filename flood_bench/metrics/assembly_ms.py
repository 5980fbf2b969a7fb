"""Face values into the simplex tree and the monotone repair a cloud:
the program's ``dim*:assembly`` and ``monotonicity`` stages."""


def read(ctx):
    vals = [sum(v for k, v in st.items()
                if k.endswith(":assembly") or k == "monotonicity")
            for st in ctx["stages"]]
    vals = [v for v in vals if v > 0]
    return sum(vals) / len(vals) * 1e3 if vals else None
