"""NumPy reference implementations used as test oracles.

These transliterate the *behavior* of the Rust reference (decision for
decision, including consumption rules and threshold tie-breaking) so the
batched device programs in ``trackmaker_tpu.phy`` can be differentially
tested without running the Rust binary.
"""

from trackmaker_tpu.oracle.phy import OracleEncoder, OracleDecoder  # noqa: F401
