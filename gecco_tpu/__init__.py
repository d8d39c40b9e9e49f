"""gecco-tpu: an accelerator-native biosynthetic gene cluster detection framework.

A from-scratch reimplementation of the capabilities of zellerlab/GECCO
(see ``/root/reference``) for accelerators: the profile-HMM domain
search and the linear-chain CRF decoding run as batched JAX/XLA (and,
for the SSV filter on a GPU, Pallas) kernels rather than wrapping native
CPU engines (pyhmmer/HMMER3, python-crfsuite, pyrodigal/Prodigal).

Pipeline (reference: ``gecco/__init__.py:1-9``, ``README.md:7-9``):

1. gene calling on genomic/metagenomic DNA (``gecco_tpu.orf``),
2. Pfam domain annotation via profile-HMM search (``gecco_tpu.hmm``),
3. per-gene cluster probabilities via a linear-chain CRF (``gecco_tpu.crf``),
4. segmentation of probability runs into clusters (``gecco_tpu.refine``),
5. biosynthetic type classification (``gecco_tpu.types``).
"""

__version__ = "0.1.0"
__author__ = "gecco-tpu developers"

__all__ = ["__version__"]
