"""setuptools shim mirroring the reference's setup.py (its pyproject is
authoritative for both projects; reference setup.py:1-16). Kept so
legacy ``python setup.py``-based tooling and the reference's install
instructions keep working against this package."""

from setuptools import find_packages, setup

setup(
    name="flooder-tpu",
    version="1.0.1",
    description="TPU-native Flood complex PH (JAX/Pallas)",
    packages=find_packages(include=["flooder_tpu", "flooder_tpu.*", "flooder_tpu_torch", "flooder_tpu_torch.*"]),
    python_requires=">=3.10",
    entry_points={
        "console_scripts": [
            "flooder = flooder_tpu.cli:main",
        ],
    },
)
