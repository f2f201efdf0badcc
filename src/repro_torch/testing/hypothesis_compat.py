"""``hypothesis``, or a seeded exemplar-corpus fallback.

Copy of ``src/repro/testing/hypothesis_compat.py`` for the PyTorch port;
it imports neither ``jax`` nor ``repro``.

The tier-1 property files (test_encoding / test_partition / test_property
/ test_rmi) must assert something even on hermetic containers where
``hypothesis`` cannot be pip-installed.  CI installs the real library via
requirements-dev.txt and gets full generative testing; when the import
fails, this module degrades ``@given`` to a deterministic corpus runner:
every strategy draws from one seeded ``random.Random`` and the test body
executes over ``min(max_examples, _FALLBACK_EXAMPLES)`` exemplars.  No
shrinking and no coverage-guided search — but every property is still
exercised on a diverse corpus instead of silently skipping.

Only the strategy surface the test-suite uses is shimmed (``integers``,
``lists``, ``binary``, ``.map``); extend it alongside any new property
test rather than reaching for ``pytest.importorskip``.
"""

from __future__ import annotations

# the module's whole purpose is re-exporting these three names
__all__ = ["HAVE_HYPOTHESIS", "given", "settings", "st"]

try:  # pragma: no cover - exercised implicitly by which branch CI takes
    from hypothesis import given, settings, strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:
    import random

    HAVE_HYPOTHESIS = False

    # enough exemplars to hit edge buckets, small enough for tier-1 speed
    _FALLBACK_EXAMPLES = 10
    _SEED = 0xE15A8

    class _Strategy:
        def __init__(self, draw):
            self._draw = draw

        def map(self, fn):
            return _Strategy(lambda rng: fn(self._draw(rng)))

    class _Strategies:
        @staticmethod
        def integers(min_value, max_value):
            # random.Random handles arbitrary-precision bounds (2**64-1)
            return _Strategy(lambda rng: rng.randint(min_value, max_value))

        @staticmethod
        def lists(elements, *, min_size=0, max_size=None):
            mx = min_size + 10 if max_size is None else max_size
            return _Strategy(
                lambda rng: [
                    elements._draw(rng)
                    for _ in range(rng.randint(min_size, mx))
                ]
            )

        @staticmethod
        def binary(*, min_size=0, max_size=None):
            mx = min_size + 10 if max_size is None else max_size
            return _Strategy(
                lambda rng: bytes(
                    rng.randrange(256)
                    for _ in range(rng.randint(min_size, mx))
                )
            )

    st = _Strategies()

    def given(*strategies):
        def deco(fn):
            # no functools.wraps: pytest follows __wrapped__ to the real
            # signature and would demand fixtures named like the strategy
            # parameters; the wrapper must present a bare (*args) signature
            def wrapper(*args, **kwargs):
                n = min(
                    getattr(wrapper, "_max_examples", _FALLBACK_EXAMPLES),
                    _FALLBACK_EXAMPLES,
                )
                rng = random.Random(_SEED)
                for _ in range(n):
                    fn(*args, *(s._draw(rng) for s in strategies), **kwargs)

            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            wrapper.__module__ = fn.__module__
            return wrapper

        return deco

    def settings(max_examples=None, **_kwargs):
        # applied above @given, so it stamps given's wrapper
        def deco(fn):
            if max_examples is not None:
                fn._max_examples = max_examples
            return fn

        return deco
