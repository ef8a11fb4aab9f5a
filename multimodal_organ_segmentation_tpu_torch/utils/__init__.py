"""Framework-free utilities copied from the JAX package (whose ``utils``
package imports JAX, so nothing there is imported)."""
