"""Temperature and top-p sampling in one pass over each row (not a TPU
kernel: it stands in for the sort, cumsum and softmaxes of the eager
``serving.sampling``): ``sample_top_p.sample_top_p`` launches it,
``ref.sample_top_p_ref`` is its plain version."""
