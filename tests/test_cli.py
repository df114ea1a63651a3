"""CLI surface tests: parser coverage + light functional runs on CPU."""

import numpy as np
import pytest

from nvfpcc_tpu.cli import build_parser, main
from nvfpcc_tpu.io.ply import write_ply_points


def _tiny_cloud(tmp_path, depth=6, n=200, seed=0):
    rng = np.random.default_rng(seed)
    size = 1 << depth
    t = rng.uniform(0, 2 * np.pi, n)
    pts = np.stack(
        [size / 2 + size * 0.3 * np.cos(t), size / 2 + size * 0.3 * np.sin(t),
         np.full_like(t, size / 2)], -1,
    )
    pts = np.unique(np.clip(np.rint(pts), 0, size - 1).astype(np.int64), axis=0)
    p = str(tmp_path / "tiny.ply")
    write_ply_points(p, pts)
    return p, pts


class TestParser:
    def test_all_subcommands_parse(self):
        ap = build_parser()
        ap.parse_args(["grids", "c.ply", "--depth", "7", "--level", "2"])
        ap.parse_args(
            ["train", "c.ply", "--lambda", "100", "--epochs", "3", "--mesh",
             "--resume", "--metrics", "m.jsonl", "--profile", "prof"]
        )
        ap.parse_args(
            ["encode", "c.ply", "--load_checkpoint", "d", "--pack_fn", "p.pk",
             "--thh", "0.6", "--qp", "16", "--platform", "cpu"]
        )
        ap.parse_args(["decode", "p.pk", "--recon", "out.ply", "--thh", "0.5"])
        ap.parse_args(["eval", "a.ply", "b.ply", "--depth", "10"])
        ap.parse_args(["weights", "c.npz", "--out", "q.npz", "--qp", "8"])

    def test_missing_subcommand_fails(self):
        with pytest.raises(SystemExit):
            build_parser().parse_args([])

    @pytest.mark.parametrize(
        "argv",
        [["grids", "c.ply"], ["train", "c.ply"], ["eval", "a.ply", "b.ply"],
         ["encode", "c.ply", "--load_checkpoint", "d"], ["decode", "p.pk"]],
    )
    def test_platform_is_default_or_cpu(self, argv):
        """--platform picks the ambient device or the host; nothing else."""
        ap = build_parser()
        assert ap.parse_args(argv).platform == "default"
        assert ap.parse_args(argv + ["--platform", "cpu"]).platform == "cpu"
        with pytest.raises(SystemExit):
            ap.parse_args(argv + ["--platform", "device"])


class TestFunctional:
    def test_grids_and_eval(self, tmp_path, capsys):
        cloud, pts = _tiny_cloud(tmp_path)
        assert main(["grids", cloud, "--depth", "6", "--level", "1"]) == 0
        art = tmp_path / "tiny_d6_l1_grids.npz"
        assert art.exists()
        data = np.load(art)
        assert data["gt"].sum() == len(pts)
        # identical clouds -> infinite D1
        assert main(["eval", cloud, cloud, "--depth", "6", "--platform", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "D1 PSNR inf" in out

    def test_cloud_out_of_cube_rejected(self, tmp_path):
        p = str(tmp_path / "bad.ply")
        write_ply_points(p, np.array([[0, 0, 4096]]))
        with pytest.raises(SystemExit):
            main(["grids", p, "--depth", "6", "--level", "1"])


class TestAutoEntropyMode:
    """`--entropy_mode auto` resolution — the defaults must match the
    measured guidance published in RESULTS.md."""

    # measured anchor clouds: vox10 sphere (round-4 driver) = 1,314 blocks
    # * 3 ch * 8 positions; vox11 sphere (round-5 capacity run) = 5,326
    # blocks * 3 * 8
    VOX10_SYMS = 1314 * 3 * 8
    VOX11_SYMS = 5326 * 3 * 8

    def test_train_resolves_by_level_and_break_even(self):
        """Round-4 decision table (RESULTS.md): channel wins at vox10 on all
        three shapes; ctx only where the ctx_post upgrade is the measured
        winner (level >= 6 AND the upgrade pays its payload)."""
        from nvfpcc_tpu.cli import resolve_auto_train

        # vox10 scale: channel everywhere, even above the symbol edge (torus)
        assert resolve_auto_train(5, self.VOX10_SYMS) == "channel"
        assert resolve_auto_train(5, 1825 * 3 * 8) == "channel"  # torus
        # vox11 sphere: the dominant ctx -> ctx_post recipe
        assert resolve_auto_train(6, self.VOX11_SYMS) == "ctx"
        assert resolve_auto_train(7, self.VOX11_SYMS) == "ctx"
        # small-but-deep: the upgrade could never pay its payload
        assert resolve_auto_train(6, 2000) == "channel"

    def test_encode_keeps_checkpoint_mode_below_break_even(self):
        from nvfpcc_tpu.cli import resolve_auto_encode

        # vox10 scale: predicted payload > stream cut (measured E4 outcome)
        assert resolve_auto_encode("ctx", 8, self.VOX10_SYMS) == (
            "ctx", 8, 0, False,
        )
        assert resolve_auto_encode("channel", 8, self.VOX10_SYMS) == (
            "channel", 8, 0, False,
        )

    def test_encode_upgrades_ctx_family_past_break_even(self):
        from nvfpcc_tpu.cli import resolve_auto_encode

        # vox11 scale: h32t24 is the measured-best candidate (round-5
        # capacity decision, results/round5/ctx_capacity2.json)
        assert resolve_auto_encode("ctx", 8, self.VOX11_SYMS) == (
            "ctx_ar", 32, 24, True,
        )
        assert resolve_auto_encode("ctx_ar", 8, self.VOX11_SYMS) == (
            "ctx_ar", 32, 24, True,
        )
        # channel-trained latents are conditionally unpredictable — no upgrade
        assert resolve_auto_encode("channel", 8, self.VOX11_SYMS) == (
            "channel", 8, 0, False,
        )

    def test_break_even_is_symbol_count_not_level(self):
        """The decision quantity is the symbol count (the round-3 level>=6
        gate misclassified small-but-deep and large-but-shallow clouds)."""
        from nvfpcc_tpu.cli import CTX_POST_ECONOMICS, ctx_post_break_even, resolve_auto_encode

        # tiny cloud: always keep the checkpoint's model
        assert resolve_auto_encode("ctx", 8, 100) == ("ctx", 8, 0, False)
        # mid-scale (old vox11 sweep cloud would be the h8-era window): under
        # the round-5 bf16-recipe cuts no candidate pays below ~93k symbols
        assert resolve_auto_encode("ctx", 8, 50_000) == ("ctx", 8, 0, False)
        # very large clouds: h32t24 still dominates (largest cut AND
        # smallest payload — no crossover to another width exists)
        mode, hidden, tail, post = resolve_auto_encode("ctx", 8, 500_000)
        assert (mode, post) == ("ctx_ar", True) and (hidden, tail) == (32, 24)
        # the first upgrade edge is the cheapest candidate's own break-even
        h0, t0, cut0, payload0 = min(
            CTX_POST_ECONOMICS, key=lambda r: r[3] / r[2]
        )
        edge = payload0 / cut0
        assert ctx_post_break_even(int(edge) - 1)[0] <= 0
        assert ctx_post_break_even(int(edge) + 2)[0] > 0
        gain, _, _ = ctx_post_break_even(0)
        assert gain < 0  # zero symbols can never pay a payload

    def test_round5_table_dominance(self):
        """h32t24 dominates every other measured candidate on both axes, so
        whenever the gate upgrades it must pick it; if a future remeasure
        breaks the dominance this test forces a deliberate re-decision."""
        from nvfpcc_tpu.cli import CTX_POST_ECONOMICS, ctx_post_break_even

        rows = {(h, t): (cut, pay) for h, t, cut, pay in CTX_POST_ECONOMICS}
        best_cut, best_pay = rows[(32, 24)]
        for (h, t), (cut, pay) in rows.items():
            if (h, t) != (32, 24):
                assert cut <= best_cut and pay >= best_pay
        for n in (100_000, 200_000, 1_000_000):
            gain, h, t = ctx_post_break_even(n)
            assert (h, t) == (32, 24)
