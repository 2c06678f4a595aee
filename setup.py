from setuptools import find_packages, setup

setup(
    name="patchperpix_tpu",
    version="0.1.0",
    description=("TPU-native PatchPerPix: proposal-free instance "
                 "segmentation from dense patch predictions "
                 "(JAX/XLA/Pallas)"),
    packages=find_packages(exclude=("tests",)),
    package_data={"patchperpix_tpu": ["native/*.cpp"],
                  "patchperpix_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "orbax-checkpoint", "numpy",
                      "scipy", "h5py", "tensorstore", "networkx", "pillow"],
    entry_points={"console_scripts":
                  ["ppp-tpu=patchperpix_tpu.cli:main"]},
)
