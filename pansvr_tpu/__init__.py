"""pansvr_tpu — a pan-genome SV realignment / force-calling engine in JAX.

A from-scratch JAX/XLA re-design with the capabilities of hitbc/panSVR
(reference mounted read-only at /root/reference; see SURVEY.md for the
behavioral spec this build follows). The pipeline stages:

  1. anchor   — SV anchor-reference construction from VCF + reference genome
                (ref: src/PanSVgenerateVCF/get_anchor_ref.hpp)
  2. index    — deBGA-style k-mer/unitig (RdBG) index, built vectorized on
                host, resident in device memory as flat int arrays
                (ref: deBGA_release/src/index_build.c, src/PanSVgenerateVCF/deBGA_index.*)
  3. signal   — signal-read extraction from BAM (ref: getSignalRead.*)
  4. align    — batched seed -> chain -> banded dual-affine-gap DP realignment
                on device (lax.scan wavefront DP)
                (ref: read_realignment.*, cpp_lib/graph.*, kswlib/ksw2_extd2_sse.c)
  5. assembly — per-SV-region contig assembly + variant calling -> VCF
                (ref: SignalAssembly.*, cpp_lib/Assembler/mantaAssembler.*)
"""

__version__ = "0.1.0"
