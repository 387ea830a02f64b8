"""Device-side ops: histogram, table build, encode/decode kernels.

Pure-XLA implementations (encode, decode_bits, compaction, lookup,
table_build) run on every backend; the Pallas-Triton kernels
(encode_triton, decode_triton) run on GPUs.  :mod:`huffman_tpu.ops.route`
holds the one rule that picks between them.
"""
