"""The host's blocking waits on the card a launch: ``waits`` over
``launches`` (``SimEngine.stats()``). An engine that waits only where the
host reads the card reads about one a retired cohort over its launches; an
engine without the counter yields no number."""


def read(r):
    if r.kind != "serve" or "waits" not in r.engine or \
            not r.engine.get("launches"):
        return None
    return r.engine["waits"] / r.engine["launches"]
