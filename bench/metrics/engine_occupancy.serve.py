"""Mean members per launch, from the engine's occupancy histogram."""


def read(r):
    if r.kind != "serve":
        return None
    occ = r.engine["occupancy"]
    n = sum(occ.values())
    if n == 0:
        return None
    return sum(int(w) * c for w, c in occ.items()) / n
