"""MVS point-cloud initialization (port of `pointnerf_tpu/models/mvs/`;
reference: models/mvs/, models/depth_estimators/)."""
