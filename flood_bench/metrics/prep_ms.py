"""K1's operands and work-list a cloud: the program's fenced ``prep:*``
stages."""


def read(ctx):
    vals = [sum(v for k, v in st.items() if k.startswith("prep:"))
            for st in ctx["stages"]]
    vals = [v for v in vals if v > 0]
    return sum(vals) / len(vals) * 1e3 if vals else None
