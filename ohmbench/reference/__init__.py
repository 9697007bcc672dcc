"""The benchmark's plain reference: what a map must hold after a sequence of
ray batches, worked out again from the rays alone.

Plain PyTorch (any device) with no import of the program under test.  The
quantisation and the line walk are frozen copies of ohm's CPU semantics
(ohm/MapRegion.cpp:32-69, ohm/LineWalkCompute.h:188-413) in float64
(``walk``); the occupancy update is the batch form that ohm's GPU path and
the measured program define (each touched voxel once per batch, from its
hit and miss counts against its batch-start value;
ohm/VoxelOccupancyCompute.h; ``occupancy``); NDT-OM adds the Gaussian miss
adjustment and the voxel mean and covariance (ohm/CovarianceVoxelCompute.h;
``ndt``).  ``compare`` decides how far two maps agree.
"""
