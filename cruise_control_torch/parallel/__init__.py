"""Host-side shape helpers of the partition and broker axes (the JAX
package's parallel/ without the mesh placement, which waits for the
multi-GPU slice)."""
