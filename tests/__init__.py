"""The test suite.  A regular package, so ``tests.<module>`` imports resolve
to this directory even where an installed distribution ships its own
top-level ``tests`` package."""
