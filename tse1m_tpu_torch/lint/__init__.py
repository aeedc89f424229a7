"""The runtime sanitizer (``runtime``); the JAX package's static lint
rules walk only that package and are not ported."""
