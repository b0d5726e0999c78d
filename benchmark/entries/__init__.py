"""One module a kind of configuration (its file's `entry`): `run(run)`
drives the program for a cell and returns a harness.Outcome."""

import dataclasses


def replace_fields(obj, values: dict):
    """A config dataclass with the fields of `values` (JSON lists as
    tuples) replaced."""
    return dataclasses.replace(obj, **{
        k: tuple(v) if isinstance(v, list) else v for k, v in values.items()})
