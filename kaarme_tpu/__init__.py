"""kaarme_tpu — canonical k-mer counting on an accelerator (JAX/XLA).

A from-scratch rebuild of the capabilities of Kaarme
(Denopia/canonical-k-mer-hash-table): streaming FASTA / plain-text
canonical k-mer counting with an optional two-stage Bloom prefilter,
re-designed as bulk device passes (JAX / XLA / shard_map) instead of
C++ threads + CAS loops.

Layout
------
- ``utils``    host-side 2-bit codec, FASTA stripping, golden oracle, math
- ``io``       chunked / gzip streaming readers with k-1 overlap carry,
               C++ fast encoder (ctypes)
- ``ops``      device kernels: sort-backend counting (flagship:
               canonical windows -> global sort -> segment-reduce),
               super-k-mer pipeline, probe-table backend, hashing,
               two-stage Bloom filter
- ``parallel`` device-mesh sharding: data-parallel streaming + hash-prefix
               all_to_all exchange of distinct records (sort backend),
               plus the sharded probe-table variant
- ``models``   end-to-end counter pipelines (sort / table / bloom;
               plain / kaarme output modes; checkpoint-resume)
- ``cli``      command-line interface mirroring the reference's surface
"""

__version__ = "0.1.0"
