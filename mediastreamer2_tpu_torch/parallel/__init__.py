"""Leg sharding over processes: ``sharding`` (the port of the JAX
package's ``parallel/sharding.py``) and ``dryrun`` (its multi-shard dry
run)."""
