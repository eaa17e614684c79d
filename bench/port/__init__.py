"""For each ``model_type`` of a configuration file, how the port runs it
(``port/<model_type>.py``): ``DEPARTURES``, each published setting the
port cannot honour with what it runs instead and why; ``as_run(c)``, the
configuration so changed, which the port and the plain reference both
run; ``config(c)``, the port's ``ModelConfig`` of it, refusing anything
else it cannot run."""


def departures(mod, c: dict) -> list:
    """(key, published value, value as run, why) of each departure that
    ``c`` meets."""
    return [(k, c.get(k, "(architecture)"), v, why)
            for k, (v, why) in mod.DEPARTURES.items() if c.get(k) != v]


def as_run(mod, c: dict) -> dict:
    return dict(c, **{k: v for k, (v, _) in mod.DEPARTURES.items()})
