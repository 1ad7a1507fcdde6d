"""The model zoo's configurations: the port's copy of ``repro.configs``.

``registry.ARCHS`` holds the ten assigned architectures and
``registry.reduced_config`` their family-preserving smoke sizes, equal
field for field to the reference's (``tests/test_torch_serve.py``).
"""
