import setuptools

from pathlib import Path

version = {}
exec((Path(__file__).parent / 'daam_tpu' / '_version.py').read_text(), version)

setuptools.setup(
    name='daam-tpu',
    version=version['__version__'],
    author='daam-tpu contributors',
    license='MIT',
    description='TPU-native diffusion attentive attribution maps (DAAM) for '
                'Stable Diffusion on JAX/Flax/Pallas',
    packages=setuptools.find_packages(exclude=('tests',)),
    package_data={'daam_tpu': ['data/clip-bpe/vocab.json',
                               'data/clip-bpe/merges.txt',
                               'native/*.cpp', 'native/*.inc'],
                  'daam_tpu_torch': ['csrc/*.cu', 'csrc/*.cuh',
                                     'native/*.cpp', 'native/*.inc']},
    python_requires='>=3.10',
    install_requires=[
        'jax', 'flax', 'numpy', 'pillow', 'matplotlib>=3.5', 'scipy',
    ],
    entry_points={
        'console_scripts': [
            'daam = daam_tpu.run.generate:main',
            'daam-evaluate = daam_tpu.run.evaluate:main',
            'daam-demo = daam_tpu.run.demo:main',
            'daam-torch = daam_tpu_torch.run.generate:main',
            'daam-torch-evaluate = daam_tpu_torch.run.evaluate:main',
            'daam-torch-demo = daam_tpu_torch.run.demo:main',
        ],
    },
)
