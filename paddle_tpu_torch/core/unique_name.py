"""Unique name generator (reference: python/paddle/fluid/unique_name.py)."""

from __future__ import annotations

import collections
import contextlib


class UniqueNameGenerator:
    def __init__(self, prefix=""):
        self.ids = collections.defaultdict(int)
        self.prefix = prefix

    def __call__(self, key: str) -> str:
        tmp = self.ids[key]
        self.ids[key] += 1
        return self.prefix + "_".join([key, str(tmp)])


generator = UniqueNameGenerator()


def generate(key: str) -> str:
    return generator(key)


def switch(new_generator=None):
    """Swap the global generator, returning the old one
    (reference: unique_name.py:58)."""
    global generator
    old = generator
    generator = new_generator or UniqueNameGenerator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    if isinstance(new_generator, str):
        new_generator = UniqueNameGenerator(new_generator)
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
