__version__ = "0.1.0"

# Version of the reference implementation whose behaviour this package
# reproduces (koszullab/chromosight, setup.py:26-29 of the reference).
REFERENCE_VERSION = "1.6.3"
