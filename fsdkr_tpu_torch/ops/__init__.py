"""Device arithmetic: limb encoding (`limbs`), the RNS route (`rns`) and
its two hand-written Hopper kernels (`rns_kernels`)."""
