"""host_bin_ms.online (host pre-binning, host clock): mean time of the
program's ``bin_scan_host`` on a raw sweep, over the window."""


def read(run):
    b = run.get("host_bin_s")
    if not b:
        return None
    return 1e3 * sum(b) / len(b)
