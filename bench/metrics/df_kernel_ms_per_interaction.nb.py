"""Device time of the port's dataframe kernels (masked_stats,
segment_reduce, topk, filter_compact, join_probe), by kernel name, inside
the profiled interactions, per interaction, in ms."""

NAMES = ("stats_tiles", "stats_merge",  # masked_stats
         "sort_hist", "sort_scan_digits", "sort_scan_tiles", "sort_scatter",  # segment_reduce
         "fold_first", "fold_level", "fill_neutral", "count_global", "count_shared",
         "topk_spans", "topk_merge",  # topk
         "tile_counts", "scatter_tiles",  # filter_compact
         "gather_sample", "probe_sampled")  # join_probe


def _df_kernel(name: str) -> bool:
    return any(n in name for n in NAMES)


def read(out):
    dt = out.rec.device_trace
    spans = dt.spans_of("interaction") if dt else []
    if not spans:
        return None
    return 1e3 * sum(dt.kernel_s(_df_kernel, s, e) for _, s, e in spans) / len(spans)
