"""The port's f64 ground truth: copies of ``ohm_tpu/oracle`` modules
(linewalk, occupancy, NDT, TSDF, and the secondary-sample mapper that
dual returns feed), with the import paths pointed at this
package.  ``tests/test_torch_host.py`` holds every copy to its source text
and its maps to the original's bit for bit."""
