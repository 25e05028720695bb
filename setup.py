"""Packaging (reference: HpBandSter ships on PyPI via setup.py, SURVEY.md §2)."""

from setuptools import find_packages, setup

setup(
    name="hpbandster_tpu",
    version="0.1.0",
    description=(
        "TPU-native distributed hyperparameter optimization: HyperBand/BOHB "
        "with batched, mesh-sharded successive halving in JAX"
    ),
    long_description=open("README.md").read(),
    long_description_content_type="text/markdown",
    packages=find_packages(include=[
        "hpbandster_tpu", "hpbandster_tpu.*",
        "hpbandster_tpu_torch", "hpbandster_tpu_torch.*",
    ]),
    # the PyTorch port's CUDA sources, compiled with nvcc at first launch
    package_data={"hpbandster_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
    ],
    extras_require={
        "viz": ["matplotlib"],
        "analysis": ["pandas"],
        "test": ["pytest"],
        "torch": ["torch"],
    },
    license="BSD-3-Clause",
)
